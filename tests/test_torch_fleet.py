"""The port's fleet layers (``fleet/traffic.py``, ``cluster.py``,
``vectorized.py``, copies; ``fleet/planner.py``, a twin whose accuracy legs
run ``ApplicationSimulator`` on the port's device) against the JAX package's.

Bars, fixed before measuring: traces, the event engine's and the vectorized
engine's cluster stats equal the reference's exactly on the same seeds (the
same numpy arithmetic); the planner on the small VGG of
``tests/conftest.py``, its weights and AE drawn with numpy in the
reference's tree, gives the same candidates, the same plan points (strings,
integers and accuracies equal, latencies and rates within 1e-12 relative,
as ``tests/test_torch_simulator.py`` holds the flows they come from), the
same suggestion and the same joint deployment report; ``plan_tiers`` the
same plans; a leg whose TCP retry budget blows is counted as infeasible on
both sides.  The accuracies are measured on 16 toy images: each is the
share of argmax hits, and the two packages' logits part by about 1e-6 of
max, far from the unsplit model's top-two gaps (checked below).  5.6 s
of test time in a 6-worker run of the whole suite.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.fleet as JF  # noqa: E402
import repro_torch.fleet as TF  # noqa: E402
from repro.core.qos import QoSRequirements as JQoS  # noqa: E402
from repro.data.synthetic import toy_images  # noqa: E402
from repro.fleet import planner as JP  # noqa: E402
from repro.models import vgg as jvgg  # noqa: E402
from repro.netsim import channel as JC  # noqa: E402
from repro.serving.engine import BatchCostModel as JBCM  # noqa: E402
from repro_torch.core.qos import QoSRequirements as TQoS  # noqa: E402
from repro_torch.fleet import planner as TP  # noqa: E402
from repro_torch.models import vgg as tvgg  # noqa: E402
from repro_torch.netsim import channel as TC  # noqa: E402
from repro_torch.params import ae_from_numpy, vgg_params_from_numpy  # noqa: E402
from repro_torch.serving.engine import BatchCostModel as TBCM  # noqa: E402
from test_torch_simulator import he_normal_like, numpy_ae  # noqa: E402

REL = 1e-12
AE_CUT = 4
N_IMAGES = 16
PKGS = {"ref": (JF, JC, JBCM, JP, JQoS), "port": (TF, TC, TBCM, TP, TQoS)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module (six test processes
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want, what="value"):
    """Dataclasses field by field (the packages' classes are twins), floats
    within REL (inf equal), the rest exactly."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, what
        for f in dataclasses.fields(want):
            _same(getattr(got, f.name), getattr(want, f.name), f"{what}.{f.name}")
    elif isinstance(want, dict):
        assert sorted(got, key=str) == sorted(want, key=str), what
        for k in want:
            _same(got[k], want[k], f"{what}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), (what, got)
        assert got == want or math.isclose(got, want, rel_tol=REL, abs_tol=0), (what, got, want)
    else:
        assert got == want, (what, got, want)


def _mix(F, C, loss=0.0):
    """tests/test_fleet.py's three device classes."""
    return [F.DeviceClass.make("mcu", C.Channel(1e-3, 1e6, 1e6, loss_rate=loss, seed=1)),
            F.DeviceClass.make("edge-embedded",
                               C.Channel(1e-4, 50e6, 50e6, loss_rate=loss, seed=2), weight=2.0),
            F.DeviceClass.make("edge-accelerator", C.Channel(1e-4, 1e9, 1e9, seed=3))]


# ------------------------------------------------------------- traffic ----
@pytest.mark.parametrize("pattern", ["poisson", "bursty", "diurnal"])
def test_traces_equal_the_reference(pattern):
    want = JF.generate_trace(_mix(JF, JC), 500, 300.0, pattern=pattern, seed=7)
    got = TF.generate_trace(_mix(TF, TC), 500, 300.0, pattern=pattern, seed=7)
    _same(got, want)
    _same(got.for_device("mcu"), want.for_device("mcu"))
    assert got.arrival_times().tolist() == want.arrival_times().tolist()
    _same(got.slice(0.2, 1.0), want.slice(0.2, 1.0))


# -------------------------------------------------------------- cluster ----
CLUSTERS = [dict(n_replicas=1, max_batch=1, batch_window_s=0.0),
            dict(n_replicas=2, max_batch=8, batch_window_s=2e-3),
            dict(n_replicas=1, max_batch=4, batch_window_s=1e-3, queue_limit=16)]


@pytest.mark.parametrize("cfg", CLUSTERS, ids=["mdc", "batched", "dropping"])
def test_cluster_engines_equal_the_reference(cfg):
    out = {}
    for pkg in ("ref", "port"):
        F, C, BCM, _, _ = PKGS[pkg]
        cost = BCM(flops_per_item=5e8, flops_per_s=1e12, fixed_overhead_s=2e-4)
        trace = F.generate_trace(_mix(F, C), 1500, 3000.0, pattern="bursty", seed=11)
        sim = F.ClusterSim(cost, F.ClusterConfig(**cfg))
        sim.offer_trace((r.rid, r.t_arrival) for r in trace.requests)
        st = sim.run()
        vs = F.simulate_cluster_vectorized(trace.arrival_times(), cost, F.ClusterConfig(**cfg))
        out[pkg] = (st, vs)
    (jst, jvs), (tst, tvs) = out["ref"], out["port"]
    _same(tst.served, jst.served)
    assert (tst.dropped, tst.batches, tst.mean_batch()) == (jst.dropped, jst.batches,
                                                            jst.mean_batch())
    for name in ("rids", "t_offer", "t_dispatch", "t_done", "drop_mask"):
        assert getattr(tvs, name).tolist() == getattr(jvs, name).tolist(), name
    assert (tvs.batches, tvs.busy_s, tvs.n_served) == (jvs.batches, jvs.busy_s, jvs.n_served)
    for p in (50, 99):
        assert tvs.percentile(p) == jvs.percentile(p)
        # and the port's engines agree with each other as the reference's do
        assert math.isclose(tvs.percentile(p), tst.percentile(p), rel_tol=TF.PCTL_RTOL,
                            abs_tol=1e-9)


# -------------------------------------------------------------- planner ----
@pytest.fixture(scope="module")
def planners():
    """The reference's and the port's planner over the small VGG with the
    same weights, an AE at AE_CUT, measured accuracy on N_IMAGES images."""
    jm = jvgg.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
    tm = tvgg.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
    p_np = he_normal_like(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 0)
    tp = vgg_params_from_numpy(tm, p_np, device="cpu")
    c = tm.activation_shapes(tp, 1)[AE_CUT][-1]
    ae_np = numpy_ae(c, 10 + AE_CUT)
    xs, _ = toy_images(N_IMAGES, hw=16, seed=55)
    with torch.inference_mode():
        logits = tm.apply(tp, torch.from_numpy(xs)).numpy()
    ys = logits.argmax(-1)
    top2 = np.sort(logits, -1)[:, -2:]
    margin = float((top2[:, 1] - top2[:, 0]).min() / np.abs(logits).max())
    fi = list(tm.cut_points())
    cs = np.linspace(1.0, 0.2, len(fi))
    kw = dict(cs_curve=cs, layer_idx=fi, eval_data=(xs, ys), n_frames=4)
    jpl = JP.DeploymentPlanner(jm, jax.tree.map(jnp.asarray, p_np),
                               ae_map={AE_CUT: jax.tree.map(jnp.asarray, ae_np)}, **kw)
    tpl = TP.DeploymentPlanner(tm, tp, ae_map={AE_CUT: ae_from_numpy(ae_np, device="cpu")},
                               device="cpu", **kw)
    return {"ref": jpl, "port": tpl, "margin": margin, "fi": fi}


def _space(pkg, fi):
    F = PKGS[pkg][0]
    # AE_CUT ranks above 9 on the falling CS curve: the SC candidate
    return F.SearchSpace(split_points=(AE_CUT, 9), protocols=("tcp", "udp"),
                         batch_sizes=(1, 4), replica_counts=(1, 2), top_k_splits=1)


def test_planner_points_and_suggestion_equal_the_reference(planners):
    assert planners["margin"] > 1e-4       # no argmax tie the two could part on
    fi, runs = planners["fi"], {}
    for pkg in ("ref", "port"):
        F, C, _, P, QoS = PKGS[pkg]
        pl = planners[pkg]
        mix = _mix(F, C, loss=0.1)[:2]
        trace = F.generate_trace(mix, 300, 150.0, seed=21)
        space = _space(pkg, fi)
        cands = pl.candidates(space)
        points = pl.search(trace, mix, space)
        plans = pl.suggest(QoS(max_latency_s=1.0, min_accuracy=0.2), (trace, mix),
                           points=points)
        report = P.simulate_deployment(plans, trace, mix, pl)
        runs[pkg] = ([tuple(c) for c in cands], points, pl.pareto_front(points), plans,
                     report, dict(pl._flow_cache))
    jc, jpts, jfront, jplans, jrep, jflows = runs["ref"]
    tc, tpts, tfront, tplans, trep, tflows = runs["port"]
    assert tc == jc == [("SC@4", AE_CUT), ("RC", None)]
    _same(tpts, jpts, "points")
    _same(tfront, jfront, "front")
    _same(tplans, jplans, "plans")
    _same(trep, jrep, "report")
    assert any(p is not None for p in tplans.values())
    for key, flow in jflows.items():
        assert tflows[key]["accuracy"] == flow["accuracy"], key
    # UDP at 10% loss costs SC accuracy on the port as on the reference
    acc = {(k[1], k[2]): f["accuracy"] for k, f in tflows.items() if k[0] == "mcu"}
    assert acc[("SC@4", "udp")] <= acc[("SC@4", "tcp")]


@pytest.mark.parametrize("engine", ["vectorized", "auto"])
def test_vectorized_search_and_deployment_equal_the_reference(planners, engine):
    fi, runs = planners["fi"], {}
    for pkg in ("ref", "port"):
        F, C, _, P, QoS = PKGS[pkg]
        pl = planners[pkg]
        mix = _mix(F, C)[1:]
        trace = F.generate_trace(mix, 400, 400.0, pattern="diurnal", seed=3)
        space = _space(pkg, fi)
        points = pl.search(trace, mix, space, engine=engine, refine=1)
        plans = pl.suggest(QoS(max_latency_s=0.5, min_accuracy=0.0), (trace, mix),
                           points=points)
        runs[pkg] = (points, plans, P.simulate_deployment(
            plans, trace, mix, pl, engine=engine, check_event_engine=engine == "vectorized"))
    _same(runs["port"], runs["ref"])


def test_plan_tiers_equal_the_reference(planners):
    runs = {}
    for pkg in ("ref", "port"):
        F, C, _, P, QoS = PKGS[pkg]
        pl = planners[pkg]
        topo = P.TierTopology((
            P.Tier("device", "mcu", C.Channel(1e-3, 20e6, 20e6, seed=1)),
            P.Tier("edge", "edge-accelerator",
                   C.Channel(1e-3, 30e6, 30e6, loss_rate=0.05, seed=2)),
            P.Tier("cloud", "server-gpu")))
        plans = pl.search_tiers(topo, n_micro=4, refine=4)
        best = P.suggest_tier_plan(plans, QoS(max_latency_s=1.0, min_accuracy=0.3))
        runs[pkg] = (plans, best, best.runtime_path(topo))
    _same(runs["port"], runs["ref"])
    assert any(p.refined for p in runs["port"][0])


def test_a_leg_past_the_retry_budget_is_infeasible(planners):
    """tests/test_faults.py's dead link: every TCP frame blows the retry
    budget, so each SC/RC leg is skipped and counted, on both sides."""
    fi, counts = planners["fi"], {}
    for pkg in ("ref", "port"):
        F, C, _, P, _ = PKGS[pkg]
        model, params = planners[pkg].model, planners[pkg].params
        kw = {"device": "cpu"} if pkg == "port" else {}
        pl = P.DeploymentPlanner(model, params, cs_curve=np.linspace(1.0, 0.2, len(fi)),
                                 layer_idx=fi, accuracy_fn=lambda s, n: 0.9,
                                 input_bytes=16 * 16 * 3 * 4, n_frames=2, **kw)
        dev = F.DeviceClass.make("mcu", C.Channel(1e-3, 1e6, 1e6, loss_rate=0.995, seed=0))
        space = F.SearchSpace(split_points=tuple(fi[:2]), protocols=("tcp",),
                              batch_sizes=(1,), replica_counts=(1,), top_k_splits=2,
                              include_rc=True)
        points = pl.search(F.generate_trace([dev], 50, 50.0, seed=0), [dev], space)
        counts[pkg] = (pl.n_infeasible_legs, len(points))
    assert counts["port"] == counts["ref"]
    assert counts["port"] == (3, 0)


def test_the_planner_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TP.DeploymentPlanner(None, None, cs_curve=[1.0], layer_idx=[0],
                             accuracy_fn=lambda s, n: 1.0, input_bytes=1)
