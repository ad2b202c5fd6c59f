"""The port's adaptive controller (``fleet/controller.py``, a copy) and its
scenario layer (``fleet/scenario.py``, the channel schedule) against the
JAX package's: on the reference's ``rush_calm`` scenario and a scenario with
a failing replica and a degrading link, the switch decisions, their reasons
and every number the run reports equal the reference's, under both cluster
engines; ``from_planner`` builds the same candidate grid from the port's
planner and decides the same.  Floats are compared exactly: both sides run
the same numpy arithmetic.  9.2 s of test time in a 6-worker run of the
whole suite.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.fleet as JF  # noqa: E402
import repro_torch.fleet as TF  # noqa: E402
from repro.netsim import channel as JC  # noqa: E402
from repro.serving.engine import BatchCostModel as JBCM  # noqa: E402
from repro_torch.netsim import channel as TC  # noqa: E402
from repro_torch.serving.engine import BatchCostModel as TBCM  # noqa: E402

PKGS = {"ref": (JF, JC, JBCM), "port": (TF, TC, TBCM)}
ENGINES = ("vectorized", "event")


@pytest.fixture(scope="module")
def vgg_pair():
    """The small VGG of tests/conftest.py in both packages, with the same
    weights drawn with numpy."""
    import jax
    import jax.numpy as jnp
    from repro.models import vgg as jvgg
    from repro_torch.models import vgg as tvgg
    from repro_torch.params import vgg_params_from_numpy
    from test_torch_simulator import he_normal_like
    jm = jvgg.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
    tm = tvgg.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
    p_np = he_normal_like(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 0)
    return {"ref": (jm, jax.tree.map(jnp.asarray, p_np)),
            "port": (tm, vgg_params_from_numpy(tm, p_np, device="cpu"))}


def _cands(F, BCM):
    cost = BCM(flops_per_item=1e7, flops_per_s=1e12, fixed_overhead_s=2e-4)
    return [F.CandidatePlan(k, "SC@3", 3, "tcp", b, 1, 5e-3, cost)
            for k, b in (("b1", 1), ("b8", 8), ("b64", 64))]


def _mix(F, C):
    return (F.DeviceClass.make("edge-embedded", C.Channel(1e-4, 100e6, 100e6, seed=1)),)


def _rush_calm(F, C):
    """tests/test_controller.py's ``rush_calm``: a morning rush only b64
    keeps up with, then a long calm tail."""
    return F.RegimeChangeTrace.from_phases(
        _mix(F, C), [F.Phase(1.0, 20000.0), F.Phase(4.0, 1500.0)], seed=7)


def _faulty(F, C):
    return F.RegimeChangeTrace.from_phases(
        _mix(F, C), [F.Phase(1.0, 20000.0), F.Phase(2.0, 1500.0)], seed=5,
        replica_events=[F.ReplicaEvent(1.2, -1), F.ReplicaEvent(2.0, +1)],
        link_events=[F.LinkDegradation(1.5, capacity_factor=0.2, latency_factor=3.0)],
        replica_pool=2)


def _view(res):
    """Everything a run decides and reports."""
    return {"plan_keys": res.plan_keys,
            "switches": [(s.t_s, s.from_key, s.to_key, s.reason, s.forced, s.n_delayed,
                          s.predicted_p99_s, s.incumbent_p99_s) for s in res.switches],
            "eras": [vars(e) for e in res.eras],
            "migration": res.migration, "dropped": res.dropped,
            "counts": (res.n_decisions, res.n_replans, res.n_suppressed, res.n_forced,
                       res.n_switches, res.n_offered),
            "latencies": res.latencies.tolist(), "p99_s": res.p99_s}


def _run(pkg, scenario, engine, **cfg_kw):
    F, C, BCM = PKGS[pkg]
    cfg = F.ControllerConfig(control_period_s=0.25, drift_threshold=0.3,
                             min_improvement=0.05, warmup_s=0.02, max_switches=4,
                             **cfg_kw)
    ctl = F.AdaptiveController(_cands(F, BCM), config=cfg)
    return _view(ctl.run(scenario(F, C), engine=engine))


@pytest.mark.parametrize("scenario", [_rush_calm, _faulty], ids=["rush_calm", "faulty"])
@pytest.mark.parametrize("engine", ENGINES)
def test_switch_decisions_equal_the_reference(scenario, engine):
    want = _run("ref", scenario, engine)
    got = _run("port", scenario, engine)
    assert got == want
    assert len(got["plan_keys"]) >= 2          # it did adapt
    if engine == "event":                       # the engines decide alike
        assert got["plan_keys"] == _run("port", scenario, "vectorized")["plan_keys"]


def test_schedules_and_degradation_equal_the_reference():
    j, t = _faulty(JF, JC), _faulty(TF, TC)
    assert t.boundaries == j.boundaries and t.horizon_s == j.horizon_s
    assert t.trace.arrival_times().tolist() == j.trace.arrival_times().tolist()
    for s in (0.0, 1.3, 1.6, 2.5):
        assert t.available_replicas(s) == j.available_replicas(s)
    base_t, base_j = TC.Channel(1e-4, 100e6, 100e6, 0.01, 1), JC.Channel(1e-4, 100e6, 100e6, 0.01, 1)
    dt = TC.degrade(base_t, capacity_factor=0.3, latency_factor=2.0, loss_add=0.05)
    dj = JC.degrade(base_j, capacity_factor=0.3, latency_factor=2.0, loss_add=0.05)
    assert vars(dt) == vars(dj)
    st = TC.ChannelSchedule(base_t, ((2.0, dt), (0.5, base_t)))
    sj = JC.ChannelSchedule(base_j, ((2.0, dj), (0.5, base_j)))
    for s in (0.0, 0.5, 1.0, 2.0, 3.0):
        assert vars(st.at(s)) == vars(sj.at(s)) and st.epoch(s) == sj.epoch(s)
    assert vars(TC.compose_channels([base_t, dt])) == vars(JC.compose_channels([base_j, dj]))
    assert TC.INTERFACES == JC.INTERFACES
    with pytest.raises(ValueError):
        TC.degrade(base_t, capacity_factor=0.0)
    with pytest.raises(ValueError):
        TC.compose_channels([])


def test_from_planner_grid_equals_the_reference(vgg_pair):
    """``from_planner`` over the port's planner and the reference's, on the
    small VGG with the same weights: the same candidate grid, the same
    decisions under both engines."""
    runs = {}
    for pkg in ("ref", "port"):
        F, C, _ = PKGS[pkg]
        model, params = vgg_pair[pkg]
        fi = list(model.cut_points())
        kw = {"device": "cpu"} if pkg == "port" else {}
        planner = F.DeploymentPlanner(
            model, params, cs_curve=np.linspace(1.0, 0.3, len(fi)), layer_idx=fi,
            accuracy_fn=lambda s, n: 0.9, input_bytes=3072, n_frames=2, **kw)
        space = F.SearchSpace(split_points=tuple(fi), batch_sizes=(1, 8),
                              replica_counts=(1,), top_k_splits=1, include_rc=True)
        ctl = F.AdaptiveController.from_planner(
            planner, space, config=F.ControllerConfig(control_period_s=0.25,
                                                      drift_threshold=0.3))
        grid = [(c.key, c.label, c.split, c.protocol, c.max_batch, c.n_replicas,
                 c.batch_window_s, c.queue_limit, vars(c.cost)) for c in ctl.candidates]
        sc = F.RegimeChangeTrace.from_phases(
            _mix(F, C), [F.Phase(0.5, 300.0), F.Phase(0.5, 40.0)], seed=1)
        runs[pkg] = (grid, [_view(ctl.run(sc, engine=e)) for e in ENGINES])
    assert len(runs["port"][0]) == 8
    assert runs["port"] == runs["ref"]
    assert runs["port"][1][0]["plan_keys"] == runs["port"][1][1]["plan_keys"]
