"""The port's ``Study`` facade (``api/study.py``, a twin) and its lazy
export map (``api/__init__.py``) against the JAX package's, with the same
weights: the small VGG of ``tests/conftest.py`` (its weights drawn with
numpy in the reference's tree), and reduced llama3.2-3b, rwkv6-1.6b and
deepseek-moe-16b (at the served capacity factor) whose backbones are the
reference's ``T.init_params(PRNGKey(0), ...)``, moved over with
``transformer_params_from_numpy``.  Every port study runs
with ``device="cpu"``.  The reference's saliency maps run under
``jax.jit`` (one compile a model, as in ``tests/test_torch_saliency.py``).

Bars, fixed before measuring: the CS curve within CS_ATOL (1e-5, the bar
of ``tests/test_torch_saliency.py``), the candidate labels equal, the
verdict latencies within 1e-9 relative (the same numpy arithmetic over the
same integers), accuracies measured on images equal (shares of argmax hits;
the logits part by about 1e-6 of max, far from the top-two gaps, checked
below), CS-proxy accuracies within CS_ATOL, the same suggestion; the fleet
plan points and suggestion at ``tests/test_torch_fleet.py``'s 1e-12, the
controller's decisions exactly; one ``fit_step``'s loss within 1e-5
relative and its gradient within 1e-4 of each leaf's max |g| (f32 sums in
other orders); a deployed runtime's argmax equal to its unsplit forward's.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.api as JA  # noqa: E402
import repro.fleet as JF  # noqa: E402
import repro_torch.api as TA  # noqa: E402
import repro_torch.fleet as TF  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import vgg16_cifar10 as JV  # noqa: E402
from repro.core import saliency as JSAL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import vgg as jvgg  # noqa: E402
from repro.models.common import reduced as jreduced  # noqa: E402
from repro.netsim import channel as JC  # noqa: E402
from repro.training.optimizer import adam_init as j_adam_init  # noqa: E402
from repro_torch.api import study as TS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import vgg16_cifar10 as TV  # noqa: E402
from repro_torch.data.synthetic import toy_image_iter, toy_images  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import reduced  # noqa: E402
from repro_torch.netsim import channel as TC  # noqa: E402
from repro_torch.netsim.simulator import flow_latency_s, measure_flow  # noqa: E402
from repro_torch.params import (ae_from_numpy, transformer_params_from_numpy,  # noqa: E402
                                vgg_params_from_numpy)
from repro_torch.runtime.engine import SplitRuntime, TailServer  # noqa: E402
from repro_torch.training.optimizer import adam_init  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_controller import _mix as _rush_mix, _view  # noqa: E402
from test_torch_fleet import _mix, _same  # noqa: E402
from test_torch_simulator import he_normal_like, numpy_ae  # noqa: E402

CS_ATOL = 1e-5
REL = 1e-9
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
CHAIN_NAMES = ["vgg16", "llama3.2-3b", "rwkv6-1.6b", "deepseek-moe-16b"]
PKGS = {"ref": (JA, JF, JC), "port": (TA, TF, TC)}
LINK_QOS = dict(max_latency_s=10.0, min_accuracy=0.0)
FLEET_SPACE = dict(protocols=("tcp", "udp"), batch_sizes=(1, 4), replica_counts=(1, 2))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module (six test processes
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jitted_reference_maps():
    """The reference's ``layer_saliency_maps`` under ``jax.jit``, a compile
    for each model: the reference ``Study.profile`` calls it through
    ``cumulative_saliency``."""
    plain, compiled = JSAL.layer_saliency_maps, {}

    def maps(model, params, x, labels):
        if id(model) not in compiled:
            compiled[id(model)] = (model, jax.jit(lambda p, x, y: plain(model, p, x, y)))
        return compiled[id(model)][1](params, x, labels)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSAL, "layer_saliency_maps", maps)
        yield


def _study(pkg, *args, **kw):
    if pkg == "port":
        kw["device"] = "cpu"
    return PKGS[pkg][0].Study(*args, **kw)


def _vgg_weights():
    """The small VGG's weights in the reference's tree, as numpy."""
    jm = jvgg.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
    return he_normal_like(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 0)


def _weights(name):
    """(reference params, port params) of a chain study."""
    if name == "vgg16":
        p_np = _vgg_weights()
        tm = TV.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
        return (jax.tree.map(jnp.asarray, p_np),
                vgg_params_from_numpy(tm, p_np, device="cpu"))
    jcfg = jreduced(jget_config(name), dtype="float32")
    jp = jax.jit(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))()
    cfg = reduced(get_config(name), dtype="float32")
    return jp, transformer_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module", params=CHAIN_NAMES)
def chain(request):
    """Both studies of one model through profile -> candidates -> simulate
    -> suggest, as tests/test_api.py runs the reference's."""
    out = {"name": request.param}
    for pkg, params in zip(("ref", "port"), _weights(request.param)):
        s = _study(pkg, request.param, params=params, seq_len=16, batch=2, seed=0)
        out[pkg] = (s, s.profile().candidates().simulate().suggest(
            PKGS[pkg][0].QoSRequirements(**LINK_QOS)))
    return out


def test_chain_cs_curve_equals_the_reference(chain):
    (js, _), (ts, _) = chain["ref"], chain["port"]
    assert ts.layer_idx == js.layer_idx
    assert ts.input_bytes == js.input_bytes
    np.testing.assert_allclose(ts.cs_curve, js.cs_curve, rtol=0, atol=CS_ATOL)


def test_chain_candidates_equal_the_reference(chain):
    (js, _), (ts, _) = chain["ref"], chain["port"]
    want = [(c.label, c.split_layer, c.compression) for c in js.candidate_list]
    assert [(c.label, c.split_layer, c.compression) for c in ts.candidate_list] == want
    for got, w in zip(ts.candidate_list, js.candidate_list):
        assert abs(got.accuracy_proxy - w.accuracy_proxy) <= CS_ATOL, got.label


def test_chain_verdicts_equal_the_reference(chain):
    (js, _), (ts, _) = chain["ref"], chain["port"]
    assert len(ts.verdicts) == len(js.verdicts)
    for got, want in zip(ts.verdicts, js.verdicts):
        assert got.candidate.label == want.candidate.label
        assert math.isclose(got.latency_s, want.latency_s, rel_tol=REL), got.candidate.label
        assert abs(got.accuracy - want.accuracy) <= CS_ATOL, got.candidate.label
        assert got.meta["wire_bytes"] == want.meta["wire_bytes"]
        assert got.meta["cost_source"] == want.meta["cost_source"] == "analytic"
    assert ([v.candidate.label for v in ts.pareto()]
            == [v.candidate.label for v in js.pareto()])


def test_chain_suggestion_equals_the_reference(chain):
    (js, jbest), (ts, tbest) = chain["ref"], chain["port"]
    assert tbest.candidate.label == jbest.candidate.label
    assert ts._suggested is tbest


def test_chain_facade_equals_the_hand_stitched_calls(chain):
    """bench_api.py's promise on the port: each verdict is the one a direct
    ``measure_flow`` gives for its candidate."""
    ts, _ = chain["port"]
    for v in ts.verdicts:
        scen = v.candidate.scenario(ts.scenario.edge, ts.scenario.server)
        flow = measure_flow(scen, ts.scenario.netcfg(), ts.model, ts.params, ts.input_bytes,
                            n_frames=ts.scenario.n_frames, sample=ts._sample)
        assert v.latency_s == flow_latency_s(flow), v.candidate.label


@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b"])
def test_unserved_families_raise(name):
    """No name is refused any more: qwen3-moe-235b-a22b, the last one a
    study refused, builds its reduced study, against the reference's with
    the same backbone (sample, labels, payload bytes, the view's logits)."""
    jp, tp = _weights(name)
    js = _study("ref", name, params=jp, seq_len=16, batch=2, seed=0)
    ts = _study("port", name, params=tp, seq_len=16, batch=2, seed=0)
    assert ts.cfg == reduced(get_config(name), dtype="float32") and ts.cfg.moe is not None
    assert ts.input_bytes == js.input_bytes
    np.testing.assert_array_equal(ts._x["tokens"].numpy(), np.asarray(js._x["tokens"]))
    np.testing.assert_array_equal(ts._labels.numpy(), np.asarray(js._labels))
    with torch.inference_mode():
        got = ts.model.apply(ts.params, ts._x).numpy()
    want = np.asarray(jax.jit(js.model.apply)(js.params, js._x))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", ["whisper-tiny", "internvl2-76b"])
def test_encdec_and_vlm_configs_are_served(name):
    """An encoder-decoder or VLM config builds its study, against the
    reference's with the same backbone: the sample drawn in the reference's
    order (tokens, patches or frames, labels; a VLM's text ``seq_len -
    n_patches`` long), the payload bytes, and the view's logits (a whisper
    view skips the encoder and the cross-attentions, as the reference's)."""
    jp, tp = _weights(name)
    js = _study("ref", name, params=jp, seq_len=16, batch=2, seed=0)
    ts = _study("port", name, params=tp, seq_len=16, batch=2, seed=0)
    assert ts.cfg.family == js.cfg.family and ts.cfg.dtype == "float32"
    assert set(ts._x) == set(js._x) and ts.input_bytes == js.input_bytes
    for k in js._x:
        assert ts._x[k].dtype == (torch.int32 if k == "tokens" else torch.float32)
        np.testing.assert_array_equal(ts._x[k].numpy(), np.asarray(js._x[k]))
    np.testing.assert_array_equal(ts._labels.numpy(), np.asarray(js._labels))
    with torch.inference_mode():
        got = ts.model.apply(ts.params, ts._x).numpy()
    want = np.asarray(jax.jit(js.model.apply)(js.params, js._x))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "jamba-v0.1-52b"])
def test_moe_configs_are_served(name):
    """A config with MoE layers (jamba with its MoE, not configs.SERVED's
    dense variant) builds its study: the reduced f32 backbone, MoE leaves
    and all, drawn from the study's seed, and the view's logits are the
    backbone's own forward's."""
    s = TS.Study(name, seq_len=16, batch=2, device="cpu")
    assert s.cfg.moe is not None and s.cfg.dtype == "float32"
    backbone = T.init_params(s.seed, s.cfg, device="cpu")
    assert "router" in backbone["layers"][f"l{s.cfg.moe.moe_every - 1}"]["ffn"]
    with torch.inference_mode():
        got = s.model.apply(s.params, s._x)
        want = T.logits_from_x(backbone, s.cfg, T.forward(backbone, s.cfg, s._x)["x"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_a_config_passed_directly_is_checked():
    """A config passed directly builds the study its name builds: reduced to
    f32, the same sample and the same view."""
    by_name = TS.Study("whisper-tiny", seq_len=16, batch=2, device="cpu")
    direct = TS.Study(get_config("whisper-tiny"), seq_len=16, batch=2, device="cpu")
    assert direct.cfg == by_name.cfg == reduced(get_config("whisper-tiny"), dtype="float32")
    assert all(torch.equal(direct._x[k], by_name._x[k]) for k in by_name._x)
    with torch.inference_mode():
        assert torch.equal(direct.model.apply(direct.params, direct._x),
                           by_name.model.apply(by_name.params, by_name._x))


def test_the_study_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.Study("vgg16")


def test_zoo_samples_are_int32_tokens():
    s = TS.Study("llama3.2-3b", seq_len=16, batch=2, device="cpu")
    assert s._x["tokens"].dtype == torch.int32 and s._labels.dtype == torch.int32
    assert s.input_bytes == 16 * 4
    with pytest.raises(NotImplementedError, match="image LayeredModels"):
        s.fit(steps=1)


# ----------------------------------------------------------- measured ----
@pytest.fixture(scope="module")
def measured():
    """Both studies over 24 toy images, profiled and ranked, a numpy-drawn
    AE at every SC cut moved into each study (the port's own AE draw is a
    ``torch.Generator``'s)."""
    p_np = _vgg_weights()
    data = toy_images(24, hw=16, seed=3)
    out = {}
    for pkg in ("ref", "port"):
        m = TV.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
        params = (jax.tree.map(jnp.asarray, p_np) if pkg == "ref"
                  else vgg_params_from_numpy(m, p_np, device="cpu"))
        out[pkg] = _study(pkg, "vgg16", params=params, data=data, seed=0).profile().candidates()
    ts = out["port"]
    shapes = ts.model.activation_shapes(ts.params, 1)
    aes = {c.split_layer: numpy_ae(shapes[c.split_layer][-1], 10 + c.split_layer)
           for c in ts.split_candidates()}
    out["ref"]._ae_map = {c: jax.tree.map(jnp.asarray, a) for c, a in aes.items()}
    ts._ae_map = {c: ae_from_numpy(a, device="cpu") for c, a in aes.items()}
    out["data"] = data
    return out


def test_measured_candidates_and_margins(measured):
    js, ts = measured["ref"], measured["port"]
    assert [c.label for c in ts.candidate_list] == [c.label for c in js.candidate_list]
    assert len(ts.split_candidates()) >= 1
    with torch.inference_mode():
        logits = ts.model.apply(ts.params, ts._x).numpy()
    top2 = np.sort(logits, -1)[:, -2:]
    assert float((top2[:, 1] - top2[:, 0]).min() / np.abs(logits).max()) > 1e-4


def test_measured_simulate_equals_the_reference(measured):
    js, ts = measured["ref"], measured["port"]
    js.simulate()
    ts.simulate()
    for got, want in zip(ts.verdicts, js.verdicts, strict=True):
        assert got.candidate.label == want.candidate.label
        assert got.accuracy == want.accuracy, got.candidate.label
        assert math.isclose(got.latency_s, want.latency_s, rel_tol=REL), got.candidate.label
        assert got.meta["cost_source"] == want.meta["cost_source"] == "analytic"
        assert got.meta["wire_bytes"] == want.meta["wire_bytes"]
    assert ts.eval_accuracy() == js.eval_accuracy()


def test_deploy_runs_the_chosen_cut(measured):
    """At the top SC cut the study's (untrained) AE rides the wire: the
    logits against the reference study's deployed runtime, at
    ``tests/test_torch_faults.py``'s 1e-3 of max.  At a legal cut with no
    AE the int8 wire keeps the unsplit argmax."""
    js, ts = measured["ref"], measured["port"]
    top = ts.split_candidates()[0]
    x = measured["data"][0][:4]
    rt = ts.deploy(candidate=top.label)
    assert isinstance(rt, SplitRuntime) and rt.part.splits == (top.split_layer,)
    assert top.split_layer in rt.part.ae_map
    got = rt.infer(x, iters=1).logits
    want = js.deploy(candidate=top.label).infer(x, iters=1).logits
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
    bare = next(c for c in ts.model.cut_points() if c not in ts._ae_map)
    rt = ts.deploy(candidate=bare)
    assert rt.part.ae_map == {}
    assert (rt.infer(x, iters=1).logits.argmax(-1) == rt.reference(x).argmax(-1)).all()
    server = ts.deploy(candidate=top.label, serve=True, n_slots=2)
    assert isinstance(server, TailServer) and server.pool.n_slots == 2
    for label in ("RC", "LC"):
        with pytest.raises(ValueError, match="nothing to split"):
            ts.deploy(candidate=label)
    with pytest.raises(TypeError):
        ts.deploy(candidate=top.label, backend="ref")


# --------------------------------------------------------- path, tiers ----
def _two_hop(C, pkg):
    """tests/test_multitier.py's two-hop path."""
    sim = (JA if pkg == "ref" else TA)
    return sim.NetworkPath((sim.NetworkConfig("tcp", C.Channel(1e-3, 20e6, 20e6, seed=1)),
                            sim.NetworkConfig("tcp", C.Channel(1e-3, 30e6, 30e6, seed=2))))


def _topology(A, C):
    """tests/test_multitier.py's three-tier topology."""
    return A.TierTopology((A.Tier("device", "mcu", C.Channel(1e-3, 20e6, 20e6, seed=1)),
                           A.Tier("edge", "edge-accelerator", C.Channel(1e-3, 30e6, 30e6, seed=2)),
                           A.Tier("cloud", "server-gpu")))


def test_path_and_tier_plans_equal_the_reference(measured):
    runs = {}
    for pkg in ("ref", "port"):
        A, _, C = PKGS[pkg]
        s = measured[pkg]
        s.simulate(path=_two_hop(C, pkg), top_m=4)
        verdicts = [(v.candidate.label, v.latency_s, v.meta["sequential_s"],
                     v.meta["speedup"], v.meta["hop_bytes"], v.meta["batch"])
                    for v in s.verdicts]
        topo = _topology(A, C)
        best = s.suggest(A.QoSRequirements(max_latency_s=1.0, min_accuracy=0.0), tiers=topo,
                         cut_counts=[2])
        plans = [(p.splits, p.stage_tiers, p.tier_index, p.latency_s, p.sequential_s)
                 for p in s.tier_plans]
        proxies = [v.accuracy for v in s.verdicts] + [p.accuracy_proxy for p in s.tier_plans]
        runs[pkg] = (proxies, verdicts, plans, (best.splits, best.stage_tiers, best.tier_index),
                     [(h.protocol, vars(h.channel)) for h in best.runtime_path(topo)])
    (jc, jv, jp, jb, jh), (tc, tv, tp, tb, th) = runs["ref"], runs["port"]
    np.testing.assert_allclose(tc, jc, rtol=0, atol=CS_ATOL)
    assert len(tv) == len(jv) > 0 and len(tp) == len(jp) > 0
    for got, want in zip(tv + tp, jv + jp):
        for g, w in zip(got, want):
            if isinstance(w, float):
                assert math.isclose(g, w, rel_tol=REL), (got, want)
            else:
                assert g == w, (got, want)
    assert tb == jb and th == jh
    # deploy() executes the suggested tier plan's cut list over its hops,
    # the study's AEs on the wire, as the reference's does
    rt = measured["port"].deploy()
    assert rt.part.splits == tb[0] and len(rt.hops) == 2
    x = measured["data"][0][:2]
    got = rt.infer(x, iters=1).logits
    want = measured["ref"].deploy().infer(x, iters=1).logits
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


# ---------------------------------------------------------------- fleet ----
def _fleet(pkg):
    F, C = PKGS[pkg][1], PKGS[pkg][2]
    mix = _mix(F, C, loss=0.1)[:2]
    return F.generate_trace(mix, 300, 150.0, seed=21), mix


def test_fleet_points_and_suggestion_equal_the_reference(measured):
    runs = {}
    for pkg in ("ref", "port"):
        s = measured[pkg]
        s.simulate(fleet=_fleet(pkg), **FLEET_SPACE)
        plans = s.suggest(PKGS[pkg][0].QoSRequirements(max_latency_s=1.0, min_accuracy=0.0))
        runs[pkg] = (s.plan_points, s.pareto(), plans)
        with pytest.raises(RuntimeError, match="fleet mode"):
            s.verdicts
    _same(runs["port"], runs["ref"])
    plans = runs["port"][2]
    assert any(p is not None for p in plans.values())
    dev = next(d for d, p in plans.items() if p is not None and p.label != "LC")
    rt = measured["port"].deploy(device=dev)
    assert rt.part.splits == (plans[dev].split_layer,)


def test_adapt_decides_as_the_reference(measured):
    """tests/test_torch_controller.py's rush then calm, each phase cut to a
    half and a quarter (a switch stays in it)."""
    runs = {}
    for pkg in ("ref", "port"):
        F, C = PKGS[pkg][1], PKGS[pkg][2]
        rush = F.RegimeChangeTrace.from_phases(
            _rush_mix(F, C), [F.Phase(0.5, 20000.0), F.Phase(1.0, 1500.0)], seed=7)
        out = measured[pkg].adapt(
            rush, batch_sizes=(1, 8, 64), replica_counts=(1,), top_k_splits=1,
            config=F.ControllerConfig(control_period_s=0.25, drift_threshold=0.3,
                                      min_improvement=0.05, warmup_s=0.02, max_switches=4))
        runs[pkg] = (_view(out["adaptive"]), _view(out["static"]),
                     [c.key for c in out["controller"].candidates])
    assert runs["port"] == runs["ref"]
    assert runs["port"][0]["counts"][4] >= 1          # it did switch


# -------------------------------------------------------------- observe ----
def test_observe_records_the_reference_names(measured, tmp_path):
    names = {}
    for pkg in ("ref", "port"):
        A, F, C = PKGS[pkg]
        s = _study(pkg, "vgg16", params=measured[pkg].params, seed=0)
        s._cs, s._layer_idx = measured[pkg].cs_curve, measured[pkg].layer_idx
        report = s.observe(window_s=0.01)
        assert s.observe() is not None
        s.calibrate(splits=[s.split_candidates()[0].split_layer], iters=1)
        s.simulate()
        s.simulate(fleet=_fleet(pkg), **FLEET_SPACE)
        s.suggest(A.QoSRequirements(max_latency_s=1.0, min_accuracy=0.0))
        assert s.deployment_stats is not None
        rt = s.deploy(candidate=s.split_candidates()[0].label)
        rt.infer(np.asarray(s._x[:2]) if pkg == "ref" else s._x[:2], iters=1)
        path = str(tmp_path / f"{pkg}.json")
        report.to_chrome_trace(path)
        names[pkg] = ({sp.name for sp in report.spans}, sorted(report.series_names()))
    assert names["port"] == names["ref"]
    assert {"study.calibrate", "infer", "request"} <= names["port"][0]


# ------------------------------------------------------------------ fit ----
def test_fit_step_equals_the_reference():
    """``fit_loss`` and its gradient, which ``fit_step`` runs, against the
    reference's loss and ``jax.grad`` as its ``Study.fit`` computes them
    (``repro/api/study.py:256-263``); then one ``fit_step``."""
    p_np = _vgg_weights()
    jm = jvgg.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
    tm = TV.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
    x, y = next(toy_image_iter(8, hw=16, seed=0, n_classes=8))
    jp = jax.tree.map(jnp.asarray, p_np)

    def lf(p):
        logits = jm.apply(p, jnp.asarray(x))
        lse = jax.nn.logsumexp(logits, -1)
        gold = jnp.take_along_axis(logits, jnp.asarray(y)[:, None], 1)[:, 0]
        return jnp.mean(lse - gold)
    jloss, jg = jax.jit(jax.value_and_grad(lf))(jp)
    tp = vgg_params_from_numpy(tm, p_np, device="cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    loss, tg = TS.B.value_and_grad(lambda p: TS.fit_loss(tm, p, xt, yt), tp)
    new, opt, step_loss = TS.fit_step(tm, tp, adam_init(tp), xt, yt, 5e-3)
    assert float(step_loss) == float(loss)
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    back = vgg_params_from_numpy(tm, jax.tree.map(np.asarray, jg), device="cpu")
    for layer, g, w in zip(tm.layers, tg, back):
        for k in w:
            scale = float(w[k].abs().max())
            assert float((g[k] - w[k]).abs().max()) <= GRAD_RTOL * scale, (layer.name, k)
    assert int(opt["t"]) == 1
    moved = [float((a - b).abs().max()) for a, b in zip(tree_leaves(new), tree_leaves(tp))]
    assert max(moved) > 0 and all(m <= 5e-3 * 1.01 for m in moved)   # Adam's first step
    assert len(tree_leaves(j_adam_init(jp)["m"])) == len(tree_leaves(opt["m"]))


def test_fit_trains_and_invalidates():
    s = TS.Study("vgg16", seed=0, device="cpu")
    before = s.eval_accuracy(n=64)
    s.profile().candidates()
    s._ae_map = {1: None}
    s.fit(steps=4, batch=8, data_iter=toy_image_iter(8, hw=16, seed=1, n_classes=8))
    assert s._cs is None and s._candidates is None and s._ae_map == {}
    assert s._calibration is None and s._mode is None
    assert 0.0 <= before <= 1.0 and 0.0 <= s.eval_accuracy(n=64) <= 1.0


# -------------------------------------------------------------- caching ----
def test_stages_are_cached_and_invalidated(measured):
    s = _study("port", "vgg16", params=measured["port"].params, seed=0)
    cs = s.cs_curve
    assert s.cs_curve is cs and s.layer_idx is s.layer_idx
    cands = s.candidate_list
    assert s.candidate_list is cands
    verdicts = s.verdicts
    qos = TA.QoSRequirements(**LINK_QOS)
    best = s.suggest(qos)
    assert s.verdicts is verdicts and s.suggest(qos).candidate == best.candidate
    s.profile()
    assert s._candidates is None and s._mode is None
    # a tier suggestion wins deploy(), until a simulate drops it
    topo = _topology(TA, TC)
    plan = s.suggest(TA.QoSRequirements(max_latency_s=1.0, min_accuracy=0.0), tiers=topo,
                     cut_counts=[2])
    assert plan is not None and s.deploy().part.splits == plan.splits
    s.simulate()
    assert s._tier_best is None
    with pytest.raises(RuntimeError, match="after suggest"):
        s.deploy()
    with pytest.raises(RuntimeError, match="plan_points"):
        s.plan_points


# ------------------------------------------------------- calibration ----
def test_calibrated_costs_price_the_verdicts(measured):
    """After ``calibrate`` the SC and RC cells are priced from the measured
    table on both sides (the times are each host's own), and each port
    verdict is the one a direct ``measure_flow`` with that table gives."""
    try:
        for pkg in ("ref", "port"):
            s = measured[pkg]
            s.calibrate(iters=1)
            s.simulate()
            kinds = {v.candidate.kind: v.meta["cost_source"] for v in s.verdicts}
            assert kinds["SC"] == kinds["RC"] == "measured", pkg
        ts, js = measured["port"], measured["ref"]
        assert sorted(ts.calibration.entries) == sorted(js.calibration.entries)
        for v, w in zip(ts.verdicts, js.verdicts, strict=True):
            assert v.accuracy == w.accuracy
            scen = v.candidate.scenario(ts.scenario.edge, ts.scenario.server)
            flow = measure_flow(scen, ts.scenario.netcfg(), ts.model, ts.params,
                                ts.input_bytes, n_frames=ts.scenario.n_frames,
                                cost=ts.calibration)
            assert math.isclose(v.latency_s, flow_latency_s(flow), rel_tol=1e-12)
            assert v.meta["wire_bytes"] == w.meta["wire_bytes"] == flow["wire_bytes"]
    finally:
        for pkg in ("ref", "port"):
            measured[pkg]._calibration = None
            measured[pkg]._mode = None


# ---------------------------------------------------------- export map ----
def test_the_export_map_is_the_references_over_the_port():
    assert TA.__all__ == JA.__all__
    assert len(TA.__all__) == 42
    for name, (module, attr) in TA._EXPORTS.items():
        assert module.startswith("repro_torch."), name
        assert module.replace("repro_torch.", "repro.", 1) == JA._EXPORTS[name][0], name
        assert attr == JA._EXPORTS[name][1]
    assert TA.Study is TS.Study and TA.StudyScenario is TS.StudyScenario
    assert "Study" in dir(TA)
    with pytest.raises(AttributeError):
        TA.NoSuchName


def test_the_vgg16_config_twin():
    assert TV.TRAIN == JV.TRAIN and TV.BOTTLENECK_TRAIN == JV.BOTTLENECK_TRAIN
    for build in ("vgg16", "vgg_cifar"):
        got, want = getattr(TV, build)(), getattr(JV, build)()
        assert [l.name for l in got.layers] == [l.name for l in want.layers]
        assert got.input_shape == want.input_shape and got.n_classes == want.n_classes


def test_study_scenario_platforms_and_channel():
    for pkg in ("ref", "port"):
        A = PKGS[pkg][0]
        sc = A.StudyScenario(edge="mcu", server="server-gpu")
        assert sc.edge is A.PLATFORMS["mcu"] and sc.netcfg().protocol == "tcp"
        assert vars(sc.channel) == vars(PKGS[pkg][2].Channel(1e-4, 1e9, 1e9, seed=0))
        with pytest.raises(KeyError, match="unknown platform"):
            A.StudyScenario(edge="quantum")
        with pytest.raises(TypeError, match="StudyScenario"):
            _study(pkg, "vgg16", scenario="edge")
    assert dataclasses.asdict(TS.StudyScenario().edge) == dataclasses.asdict(
        JA.StudyScenario().edge)
