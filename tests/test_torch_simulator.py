"""The port's simulator (``netsim/simulator.py``, ``netsim/analytic.py``),
scenarios (``core/scenarios.py``), cost layer (``api/types.py``) and
``serving.engine.BatchCostModel`` against the JAX package, on the small VGG
of ``tests/conftest.py`` (``vgg_cifar(8, 16, 0.25)``, its weights and AEs
drawn with numpy in the reference's tree).

Bars, fixed before measuring: every number the two packages compute from
the same FLOP counts, payloads and transfer draws equal, a float within
1e-12 relative (the same numpy arithmetic); ``ApplicationSimulator``'s
latency and ``meta`` so too, its accuracy equal, and the logits of each
chunk it runs within 1e-4 relative and 1e-5 absolute (f32 convolutions
summed in other orders, as ``tests/test_torch_runtime.py`` holds them).
"""
import dataclasses
import importlib
import math
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import types as JTY  # noqa: E402
from repro.core import scenarios as JSC  # noqa: E402
from repro.core.split import SplitPlan as JPlan  # noqa: E402
from repro.data.synthetic import toy_images  # noqa: E402
from repro.models import vgg as jvgg  # noqa: E402
from repro.netsim import analytic as JAN  # noqa: E402
from repro.netsim import simulator as JSIM  # noqa: E402
from repro.netsim.channel import Channel as JChannel  # noqa: E402
from repro.serving.engine import BatchCostModel as JBCM  # noqa: E402
from repro_torch.api import types as TTY  # noqa: E402
from repro_torch.core import scenarios as TSC  # noqa: E402
from repro_torch.core.split import SplitPlan as TPlan  # noqa: E402
from repro_torch.models import vgg as tvgg  # noqa: E402
from repro_torch.netsim import analytic as TAN  # noqa: E402
from repro_torch.netsim import simulator as TSIM  # noqa: E402
from repro_torch.netsim.channel import Channel as TChannel  # noqa: E402
from repro_torch.params import ae_from_numpy, vgg_params_from_numpy  # noqa: E402
from repro_torch.runtime import calibrate as TCAL  # noqa: E402
from repro_torch.serving.engine import BatchCostModel as TBCM  # noqa: E402

# the module, which ``repro.runtime`` shadows with its ``calibrate`` function
JCAL = importlib.import_module("repro.runtime.calibrate")

REL = 1e-12
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-5
AE_CUTS = (4, 9)                 # pool4 (8, 8, 8) and pool9 (4, 4, 16)
PATH_CUTS = (4, 9)
INPUT_BYTES = 16 * 16 * 3 * 4
N_IMAGES = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module: its tensors are
    small, and the tier-1 run keeps six test processes busy on the host's
    cores at once, where an op's thread pool mostly waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def he_normal_like(shapes, seed):
    """Weights for a reference params tree of ``ShapeDtypeStruct``s, drawn
    with numpy, without compiling a JAX init: normal with std
    sqrt(2 / fan-in), and biases 0."""
    rng = np.random.default_rng(seed)

    def draw(s):
        if len(s.shape) < 2:
            return np.zeros(s.shape, s.dtype)
        std = np.sqrt(2.0 / np.prod(s.shape[:-1]))
        return (std * rng.standard_normal(s.shape)).astype(s.dtype)
    return jax.tree.map(draw, shapes)


def numpy_ae(c, seed, rate=0.5):
    """An AE in the reference's tree, drawn with numpy as its init scales it."""
    rng = np.random.default_rng(seed)
    cl = max(1, int(round(c * rate)))
    return {"enc": {"w": (rng.standard_normal((c, cl)) / np.sqrt(c)).astype(np.float32),
                    "b": np.zeros(cl, np.float32)},
            "dec": {"w": (rng.standard_normal((cl, c)) / np.sqrt(cl)).astype(np.float32),
                    "b": np.zeros(c, np.float32)}}


@pytest.fixture(scope="module")
def pair():
    """(JAX model, params, AEs; port model, params, AEs; a 2-image sample each)."""
    jm = jvgg.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
    tm = tvgg.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
    p_np = he_normal_like(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 0)
    shapes = tm.activation_shapes(tm.init(0, device="cpu"), 1)
    aes_np = {c: numpy_ae(shapes[c][-1], 10 + c) for c in AE_CUTS}
    x = toy_images(2, hw=16, seed=5)[0]
    return {"jm": jm, "jp": jax.tree.map(jnp.asarray, p_np),
            "jaes": {c: jax.tree.map(jnp.asarray, a) for c, a in aes_np.items()},
            "tm": tm, "tp": vgg_params_from_numpy(tm, p_np, device="cpu"),
            "taes": {c: ae_from_numpy(a, device="cpu") for c, a in aes_np.items()},
            "jsample": jnp.asarray(x), "tsample": torch.from_numpy(x)}


def _same(got, want, what="value"):
    """``got`` (the port's) equals ``want`` (the reference's): structure
    and integers exactly, floats within REL, dataclasses field by field
    (the two packages' classes are twins, not one class)."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, what
        for f in dataclasses.fields(want):
            _same(getattr(got, f.name), getattr(want, f.name), f"{what}.{f.name}")
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _same(got[k], want[k], f"{what}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, what
        assert np.array_equal(got, want), what
    elif isinstance(want, float):
        assert isinstance(got, float), what
        assert math.isclose(got, want, rel_tol=REL, abs_tol=0), (what, got, want)
    else:
        assert type(got) is type(want) and got == want, (what, got, want)


def _path(pkg_channel, pkg_sim, proto, loss):
    return pkg_sim.NetworkPath((
        pkg_sim.NetworkConfig(proto, pkg_channel(1e-3, 20e6, 20e6, loss_rate=loss, seed=1)),
        pkg_sim.NetworkConfig(proto, pkg_channel(1e-3, 30e6, 30e6, loss_rate=loss, seed=2))))


# ------------------------------------------------------ pipelined path ----
@pytest.mark.parametrize("n_micro", [1, 4])
@pytest.mark.parametrize("proto", ["tcp", "udp"])
@pytest.mark.parametrize("loss", [0.0, 0.1])
def test_pipeline_and_its_closed_form_equal_the_reference(n_micro, proto, loss):
    stage_s, hop_bytes = [2e-3, 5e-3, 1e-3], [60_000, 9_001]
    jpath, tpath = _path(JChannel, JSIM, proto, loss), _path(TChannel, TSIM, proto, loss)
    want = JSIM.simulate_pipeline(stage_s, hop_bytes, jpath, n_micro=n_micro,
                                  check_closed_form=True)
    got = TSIM.simulate_pipeline(stage_s, hop_bytes, tpath, n_micro=n_micro,
                                 check_closed_form=True)
    _same(got, want, "pipeline")
    assert got.speedup == want.speedup
    _same(TAN.closed_form_pipeline(stage_s, hop_bytes, tpath, n_micro=n_micro),
          JAN.closed_form_pipeline(stage_s, hop_bytes, jpath, n_micro=n_micro), "closed form")
    _same(TAN.path_params(tpath), JAN.path_params(jpath), "path params")
    assert TAN.path_params(tpath).exact == (loss == 0.0)


# ---------------------------------------------------- analytic pricing ----
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("with_sample", [False, True])
def test_scenario_pricing_equals_the_reference(pair, batch, with_sample):
    jm, jp, tm, tp = pair["jm"], pair["jp"], pair["tm"], pair["tp"]
    jkw = {"sample": pair["jsample"]} if with_sample else {}
    tkw = {"sample": pair["tsample"]} if with_sample else {}
    for kind, cuts in (("LC", None), ("RC", None), ("SC", (9,)), ("SC", PATH_CUTS)):
        jplan = None if cuts is None else JPlan(None, splits=cuts)
        tplan = None if cuts is None else TPlan(None, splits=cuts)
        want = JSC.scenario_times_and_payload(JSC.Scenario(kind, jplan), jm, jp, INPUT_BYTES,
                                              batch, **jkw)
        got = TSC.scenario_times_and_payload(TSC.Scenario(kind, tplan), tm, tp, INPUT_BYTES,
                                             batch, **tkw)
        _same(got, want, f"{kind} {cuts}")
        if cuts is not None:
            tiers = [TSC.PLATFORMS[n] for n in ("mcu", "edge-accelerator", "server-gpu")]
            jtiers = [JSC.PLATFORMS[n] for n in ("mcu", "edge-accelerator", "server-gpu")]
            k = len(cuts) + 1
            _same(TSC.stage_times_and_payloads(tm, tp, tplan, tiers[-k:], batch, **tkw),
                  JSC.stage_times_and_payloads(jm, jp, jplan, jtiers[-k:], batch, **jkw),
                  f"stages {cuts}")
    for rate, wire in ((0.5, 4), (0.25, 1)):
        _same(TSC.cut_payload_bytes_lut(tm, tp, batch, compression=rate,
                                        wire_dtype_bytes=wire, **tkw),
              JSC.cut_payload_bytes_lut(jm, jp, batch, compression=rate,
                                        wire_dtype_bytes=wire, **jkw), "lut")


def test_platforms_and_scenarios_equal_the_reference():
    _same(TSC.PLATFORMS, JSC.PLATFORMS, "PLATFORMS")
    assert TSC.EDGE_PLATFORM_NAMES == JSC.EDGE_PLATFORM_NAMES
    _same(TSC.edge_platform("mcu"), JSC.edge_platform("mcu"))
    for name in ("server-gpu", "nope"):
        with pytest.raises(KeyError) as want:
            JSC.edge_platform(name)
        with pytest.raises(KeyError) as got:
            TSC.edge_platform(name)
        assert str(got.value) == str(want.value)
    for cand in ("LC", "RC", (4,), (4, 9)):
        j = JTY.SplitCandidate.from_any(cand)
        t = TTY.SplitCandidate.from_any(cand)
        _same(t.scenario(), j.scenario(), f"{cand}.scenario()")
        edge, server = TSC.PLATFORMS["mcu"], TSC.PLATFORMS["tpu-v5e-chip"]
        _same(t.scenario(edge, server),
              j.scenario(JSC.PLATFORMS["mcu"], JSC.PLATFORMS["tpu-v5e-chip"]))
        assert t.scenario().label() == j.scenario().label()
    hil = TSC.HILPlatform("host")
    assert hil.compute_time(5e9) == JSC.HILPlatform("host").compute_time(5e9) == 0.1
    hil.measure("id", lambda v: v + 1, torch.zeros(4), iters=2)
    assert hil.compute_time(1.0, key="id") == hil._measured["id"] > 0


def test_batch_cost_model_equals_the_reference(pair):
    jm, jp, tm, tp = pair["jm"], pair["jp"], pair["tm"], pair["tp"]
    server = (JSC.PLATFORMS["server-gpu"], TSC.PLATFORMS["server-gpu"])
    for split in (None, 1, 9, 17):
        for jkw, tkw in (({}, {}), ({"sample": pair["jsample"]}, {"sample": pair["tsample"]})):
            want = JBCM.for_split(jm, jp, split, server[0], **jkw)
            got = TBCM.for_split(tm, tp, split, server[1], **tkw)
            _same(got, want, f"for_split {split}")
            for b in (1, 8):
                _same(got.service_time(b), want.service_time(b))
                _same(got.throughput(b), want.throughput(b))
    _same(TBCM.from_measured(3e-3, 60e12, fixed_overhead_s=1e-4),
          JBCM.from_measured(3e-3, 60e12, fixed_overhead_s=1e-4))


def _tables(pkg_cal, batch=2):
    """A calibration table with one measured SC cell, as both packages hold it."""
    t = pkg_cal.CalibrationTable("vgg_cifar", batch)
    t.put("SC", 9, pkg_cal.CalEntry(1e-3, 2e-3, 777, 1e-4, 2e-4))
    t.put("LC", None, pkg_cal.CalEntry(4e-3, 0.0, 0))
    return t


def test_cost_layer_equals_the_reference(pair):
    jm, jp, tm, tp = pair["jm"], pair["jp"], pair["tm"], pair["tp"]
    plat = ("edge-accelerator", "server-gpu")
    ja = JTY.AnalyticCost(jm, jp, INPUT_BYTES, *(JSC.PLATFORMS[p] for p in plat), batch=2)
    ta = TTY.AnalyticCost(tm, tp, INPUT_BYTES, *(TSC.PLATFORMS[p] for p in plat), batch=2)
    assert isinstance(ta, TTY.CostModel) and isinstance(_tables(TCAL), TTY.CostModel)
    js, ts = JTY.CostStack([_tables(JCAL), ja]), TTY.CostStack([_tables(TCAL), ta])
    assert ts.batch == js.batch == 2 and TTY.CostStack([]).batch == 1
    for kind, split in (("LC", None), ("RC", None), ("SC", 4), ("SC", 9)):
        for batch in (None, 2, 5):
            _same(ta.flow_times(kind, split, batch), ja.flow_times(kind, split, batch),
                  f"analytic {kind}@{split} batch {batch}")
            _same(ts.flow_times(kind, split, batch), js.flow_times(kind, split, batch),
                  f"stack {kind}@{split} batch {batch}")
        _same(ta.server_cost(split, TSC.PLATFORMS["server-gpu"]),
              ja.server_cost(split, JSC.PLATFORMS["server-gpu"]))
        _same(ts.server_cost(split, TSC.PLATFORMS["server-gpu"]),
              js.server_cost(split, JSC.PLATFORMS["server-gpu"]))
    assert ts.flow_times("SC", 9)["cost_source"] == "measured"
    assert ts.flow_times("SC", 4)["cost_source"] == "analytic"
    assert TTY.CostStack([_tables(TCAL)]).flow_times("RC") is None
    times = {"edge_s": 1e-3, "server_s": 3e-3, "wire_bytes": 1001, "cost_source": "x"}
    for src, dst in ((2, 2), (0, 7), (2, 5), (3, 1)):
        _same(TTY.scale_flow_times(times, src, dst), JTY.scale_flow_times(times, src, dst))


# ------------------------------------------------------------- flows ----
def _frames_equal(got, want, what):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert (g.duration_s, g.n_packets, g.n_transmissions) == \
            (w.duration_s, w.n_packets, w.n_transmissions), what
        assert np.array_equal(g.delivered, w.delivered), what


def _flows_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        if k in ("frames",):
            _frames_equal(got[k], want[k], f"{what} {k}")
        elif k == "hop_frames":
            for g, w in zip(got[k], want[k]):
                _frames_equal(g, w, f"{what} {k}")
        else:
            _same(got[k], want[k], f"{what} {k}")


@pytest.mark.parametrize("proto", ["tcp", "udp"])
def test_measure_flow_on_one_link_equals_the_reference(pair, proto):
    jm, jp, tm, tp = pair["jm"], pair["jp"], pair["tm"], pair["tp"]
    jnet = JSIM.NetworkConfig(proto, JChannel(1e-3, 100e6, 100e6, loss_rate=0.2, seed=3))
    tnet = TSIM.NetworkConfig(proto, TChannel(1e-3, 100e6, 100e6, loss_rate=0.2, seed=3))
    for kind, split in (("LC", None), ("RC", None), ("SC", 9)):
        jsc = JSC.Scenario(kind, None if split is None else JPlan(split))
        tsc = TSC.Scenario(kind, None if split is None else TPlan(split))
        for batch in (1, 3):
            want = JSIM.measure_flow(jsc, jnet, jm, jp, INPUT_BYTES, 5, batch=batch)
            got = TSIM.measure_flow(tsc, tnet, tm, tp, INPUT_BYTES, 5, batch=batch)
            _flows_equal(got, want, f"{kind} batch {batch}")
            assert TSIM.flow_latency_s(got) == JSIM.flow_latency_s(want)


@pytest.mark.parametrize("kind", ["SC", "RC", "LC"])
def test_measure_flow_on_a_path_equals_the_reference(pair, kind):
    jm, jp, tm, tp = pair["jm"], pair["jp"], pair["tm"], pair["tp"]
    names = ("mcu", "edge-accelerator", "server-gpu")
    jsc = JSC.Scenario(kind, JPlan(None, splits=PATH_CUTS) if kind == "SC" else None)
    tsc = TSC.Scenario(kind, TPlan(None, splits=PATH_CUTS) if kind == "SC" else None)
    for proto, loss in (("tcp", 0.0), ("tcp", 0.1), ("udp", 0.3)):
        jpath, tpath = _path(JChannel, JSIM, proto, loss), _path(TChannel, TSIM, proto, loss)
        for tiers, n_micro in ((None, None), (names, 4)):
            jt = None if tiers is None else tuple(JSC.PLATFORMS[n] for n in tiers)
            tt = None if tiers is None else tuple(TSC.PLATFORMS[n] for n in tiers)
            want = JSIM.measure_flow(jsc, jpath, jm, jp, INPUT_BYTES, 3, batch=2,
                                     tiers=jt, n_micro=n_micro)
            got = TSIM.measure_flow(tsc, tpath, tm, tp, INPUT_BYTES, 3, batch=2,
                                    tiers=tt, n_micro=n_micro)
            _flows_equal(got, want, f"{kind} {proto} {loss} {tiers}")
            assert TSIM.flow_latency_s(got) == JSIM.flow_latency_s(want)
    # a hop sequence and a bare channel coerce alike
    assert TSIM.as_path([TChannel(1e-3, 1e6, 1e6)], "udp")[0].protocol == "udp"
    assert len(TSIM.as_path(TChannel(1e-3, 1e6, 1e6))) == 1


def test_cost_and_the_deprecated_calibration_alias_equal_the_reference(pair):
    jm, jp, tm, tp = pair["jm"], pair["jp"], pair["tm"], pair["tp"]
    jnet = JSIM.NetworkConfig("tcp", JChannel(1e-3, 100e6, 100e6, seed=0))
    tnet = TSIM.NetworkConfig("tcp", TChannel(1e-3, 100e6, 100e6, seed=0))
    jsc, tsc = JSC.Scenario("SC", JPlan(9)), TSC.Scenario("SC", TPlan(9))
    for batch in (1, 2, 4):
        _flows_equal(TSIM.measure_flow(tsc, tnet, tm, tp, INPUT_BYTES, cost=_tables(TCAL),
                                       batch=batch),
                     JSIM.measure_flow(jsc, jnet, jm, jp, INPUT_BYTES, cost=_tables(JCAL),
                                       batch=batch), f"cost batch {batch}")
        with pytest.warns(DeprecationWarning, match="calibration=") as tw:
            got = TSIM.measure_flow(tsc, tnet, tm, tp, INPUT_BYTES,
                                    calibration=_tables(TCAL), batch=batch)
        with pytest.warns(DeprecationWarning, match="calibration=") as jw:
            want = JSIM.measure_flow(jsc, jnet, jm, jp, INPUT_BYTES,
                                     calibration=_tables(JCAL), batch=batch)
        assert str(tw[0].message) == str(jw[0].message).replace("repro.api", "repro_torch.api")
        _flows_equal(got, want, f"calibration= batch {batch}")
        assert got["cost_source"] == "measured"

    class Legacy:
        """The contract before the cost layer: ``flow_times(kind, split)``
        and ``lookup``, no batch."""
        batch = 2

        def __init__(self, cal):
            self.table = _tables(cal)

        def flow_times(self, kind, split=None):
            return self.table.flow_times(kind, split)

        def lookup(self, kind, split=None):
            return self.table.lookup(kind, split)

    jl, tl = JSIM._LegacyCalibration(Legacy(JCAL)), TSIM._LegacyCalibration(Legacy(TCAL))
    for split in (None, 4, 9):
        _same(tl.flow_times("SC", split, batch=4), jl.flow_times("SC", split, batch=4))
        _same(tl.server_cost(split, TSC.PLATFORMS["server-gpu"]),
              jl.server_cost(split, JSC.PLATFORMS["server-gpu"]))
    # a multi-hop path ignores cost= with a warning, on both
    tpath = _path(TChannel, TSIM, "tcp", 0.0)
    with pytest.warns(UserWarning, match="cost sources only price 2-tier cells"):
        TSIM.measure_flow(tsc, TSIM.NetworkPath((tpath[0],)), tm, tp, INPUT_BYTES,
                          cost=_tables(TCAL))


@pytest.mark.parametrize("loss", [0.0, 0.3, 1.0])
def test_chunk_masks_equal_the_reference(loss):
    ch_j, ch_t = (c(1e-4, 1e9, 1e9, loss_rate=loss, seed=4) for c in (JChannel, TChannel))
    for n_elems, elem_bytes in ((2048, 4), (999, 1), (1, 4)):
        n_bytes = n_elems * elem_bytes
        for stream in range(3):
            dj = JSIM.simulate_transfer("udp", n_bytes, ch_j, stream=stream).delivered
            dt = TSIM.simulate_transfer("udp", n_bytes, ch_t, stream=stream).delivered
            assert np.array_equal(dt, dj)
            _same(TSIM.chunk_mask_from_packets(n_elems, dt, elem_bytes, 1500),
                  JSIM.chunk_mask_from_packets(n_elems, dj, elem_bytes, 1500))


# -------------------------------------------------- the application ----
SCENARIOS = ["LC", "RC"] + [f"SC@{c}" for c in AE_CUTS]


@pytest.fixture(scope="module")
def images():
    return toy_images(N_IMAGES, hw=16, seed=21)


def _recorder(sim):
    """Wrap ``sim._apply_batched`` to keep the logits it returns."""
    kept, plain = [], sim._apply_batched

    def rec(*args, **kw):
        out = plain(*args, **kw)
        kept.append(np.asarray(out))
        return out
    sim._apply_batched = rec
    return kept


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("proto", ["tcp", "udp"])
@pytest.mark.parametrize("loss", [0.0, 0.3])
def test_application_simulator_equals_the_reference(pair, images, scenario, proto, loss):
    xs, ys = images
    cut = int(scenario[3:]) if scenario.startswith("SC") else None
    jnet = JSIM.NetworkConfig(proto, JChannel(100e-6, 1e9, 1e9, loss_rate=loss, seed=11))
    tnet = TSIM.NetworkConfig(proto, TChannel(100e-6, 1e9, 1e9, loss_rate=loss, seed=11))
    jsim = JSIM.ApplicationSimulator(pair["jm"], pair["jp"], jnet,
                                     ae=None if cut is None else pair["jaes"][cut])
    tsim = TSIM.ApplicationSimulator(pair["tm"], pair["tp"], tnet, device="cpu",
                                     ae=None if cut is None else pair["taes"][cut])
    jsc = JSC.Scenario(scenario[:2], None if cut is None else JPlan(cut))
    tsc = TSC.Scenario(scenario[:2], None if cut is None else TPlan(cut))
    jkept, tkept = _recorder(jsim), _recorder(tsim)
    want = jsim.simulate(jsc, xs, ys, n_frames=4)
    got = tsim.simulate(tsc, xs, ys, n_frames=4)
    assert got.latency_s == want.latency_s
    _same(got.meta, want.meta, "meta")
    _same(got.candidate, want.candidate, "candidate")
    assert got.accuracy == want.accuracy
    assert len(tkept) == len(jkept) == 1
    np.testing.assert_allclose(tkept[0], jkept[0], rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    if proto == "udp" and cut is not None:
        # the receiver's masks on the wire tensor, and predict on them alone
        flow = TSIM.measure_flow(tsc, tnet, pair["tm"], pair["tp"], INPUT_BYTES, 4)
        masks = tsim.loss_masks(tsc, flow["frames"], 2, xs.shape[1:])
        lat = pair["tm"].activation_shapes(pair["tp"], 1)[cut][1:-1]
        assert masks.shape == (2, int(np.prod(lat)) * pair["taes"][cut]["enc"]["w"].shape[1])
        np.testing.assert_array_equal(tsim.predict(tsc, xs[:2], masks), tkept[0][:2])


def test_application_simulator_reuses_a_given_flow(pair, images):
    xs, ys = images
    tnet = TSIM.NetworkConfig("tcp", TChannel(100e-6, 1e9, 1e9, seed=11))
    tsim = TSIM.ApplicationSimulator(pair["tm"], pair["tp"], tnet, device="cpu",
                                     ae=pair["taes"][9])
    tsc = TSC.Scenario("SC", TPlan(9))
    flow = TSIM.measure_flow(tsc, tnet, pair["tm"], pair["tp"], INPUT_BYTES, 2,
                             cost=_tables(TCAL))
    v = tsim.simulate(tsc, xs[:4], ys[:4], flow=flow)
    # the table's batch-2 cell, rescaled to the flow's one frame
    assert v.meta["edge_s"] == flow["edge_s"] == _tables(TCAL).lookup("SC", 9).edge_s / 2
    assert v.meta["wire_bytes"] == flow["wire_bytes"] == round(777 / 2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tsim.simulate(TSC.Scenario("LC"), xs[:4], ys[:4], n_frames=2)
