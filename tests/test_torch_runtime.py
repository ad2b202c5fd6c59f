"""The port's split runtime against the JAX package's on the small VGG:
the same weights, inputs and AEs, carried across as numpy arrays."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bottleneck as JB  # noqa: E402
from repro.obs import Recorder as JRecorder  # noqa: E402
from repro.runtime import engine as JE  # noqa: E402
from repro_torch.core import bottleneck as TB  # noqa: E402
from repro_torch.models import vgg as tvgg  # noqa: E402
from repro_torch.netsim.channel import Channel as TChannel  # noqa: E402
from repro_torch.obs import Recorder  # noqa: E402
from repro_torch.params import ae_from_numpy, vgg_params_from_numpy  # noqa: E402
from repro_torch.runtime import engine as TE  # noqa: E402
from repro_torch.runtime import wire as TW  # noqa: E402
from repro_torch.netsim.simulator import ApplicationSimulator, NetworkConfig  # noqa: E402
from repro_torch.runtime.calibrate import calibrate  # noqa: E402
from repro_torch.runtime.partition import make_partition  # noqa: E402
from repro.netsim.channel import Channel as JChannel  # noqa: E402

CUTS = tvgg.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25).cut_points()
# a conv cut (after its ReLU), a pool cut, flatten and an fc cut
REPRESENTATIVE = [6, 9, 15, 17]
# logits of the quantised kinds, relative to max |logit|: a code may move by
# one at a rounding tie between the two codecs (see test_torch_kernels)
QUANT_RTOL = 1e-3


@pytest.fixture(scope="module")
def setup(vgg_small):
    jm, jp = vgg_small
    tm = tvgg.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
    tp = vgg_params_from_numpy(tm, jax.tree.map(np.asarray, jp), device="cpu")
    shapes = jm.activation_shapes(jp, 1)
    jaes = {c: JB.init_bottleneck(jax.random.PRNGKey(10 + c), tuple(shapes[c][1:]), 0.5)
            for c in REPRESENTATIVE}
    taes = {c: ae_from_numpy(jax.tree.map(np.asarray, a), device="cpu")
            for c, a in jaes.items()}
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 3)).astype(np.float32)
    return jm, jp, tm, tp, jaes, taes, x


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("cut", CUTS)
def test_f32_logits_match_reference_at_every_legal_cut(setup, cut):
    jm, jp, tm, tp, _, _, x = setup
    jr = JE.SplitRuntime(jm, jp, cut, quantize=False).infer(x, iters=1)
    tr = TE.SplitRuntime(tm, tp, cut, quantize=False, device="cpu").infer(x, iters=1)
    np.testing.assert_allclose(tr.logits, np.asarray(jr.logits), rtol=1e-4, atol=1e-5)
    assert tr.wire_bytes == jr.wire_bytes


@pytest.mark.parametrize("cut", REPRESENTATIVE)
@pytest.mark.parametrize("kind", ["int8", "ae8"])
def test_quantised_logits_match_reference(setup, cut, kind):
    jm, jp, tm, tp, jaes, taes, x = setup
    jae, tae = (jaes[cut], taes[cut]) if kind == "ae8" else (None, None)
    jr = JE.SplitRuntime(jm, jp, cut, ae=jae).infer(x, iters=1)
    tr = TE.SplitRuntime(tm, tp, cut, ae=tae, device="cpu").infer(x, iters=1)
    assert _rel(tr.logits, np.asarray(jr.logits)) < QUANT_RTOL
    assert tr.wire_bytes == jr.wire_bytes
    assert tr.meta["fused"] is False and tr.splits == (cut,)


def test_fused_equals_eager_bytes_and_logits(setup):
    _, _, tm, tp, _, taes, x = setup
    part = make_partition(tm, tp, (6, 9, 17), {c: taes[c] for c in (6, 9)},
                          device="cpu")
    assert part.wire_kinds() == ("ae8", "ae8", "int8")
    xt = torch.tensor(x)
    cur, eager = xt, []
    for k in range(part.n_stages):
        cur = part.stage(k)(cur)
        if k < len(part.splits):
            ae = part.ae_map.get(part.splits[k])
            eager.append(TW.to_bytes(TW.encode_activation(cur, ae)))
            cur = TW.decode_activation(TW.from_bytes(eager[-1]), ae, device="cpu")
    segs = part.fused_segments()
    out, fused = segs[0](xt), []
    for k in range(len(part.splits)):
        fused.append(TW.frame_arrays(part.wire_kinds()[k], *out))
        out = segs[k + 1](TW.parse_arrays(fused[-1], device="cpu"))
    assert fused == eager and torch.equal(out, cur)
    te = TE.SplitRuntime(tm, tp, (6, 9, 17), ae={c: taes[c] for c in (6, 9)},
                         device="cpu").infer(x, iters=1)
    tf = TE.SplitRuntime(tm, tp, (6, 9, 17), ae={c: taes[c] for c in (6, 9)},
                         fused=True, device="cpu").infer(x, iters=1)
    np.testing.assert_array_equal(te.logits, tf.logits)
    assert te.wire_bytes == tf.wire_bytes == sum(len(b) for b in eager)
    np.testing.assert_array_equal(part.fused_forward(xt).numpy(), te.logits)


def test_multi_cut_int8_matches_reference(setup):
    jm, jp, tm, tp, _, _, x = setup
    jr = JE.SplitRuntime(jm, jp, (4, 14)).infer(x, iters=1)
    tr = TE.SplitRuntime(tm, tp, (4, 14), device="cpu").infer(x, iters=1)
    assert _rel(tr.logits, np.asarray(jr.logits)) < QUANT_RTOL
    assert [h["bytes"] for h in tr.hops] == [h["bytes"] for h in jr.hops]


@pytest.mark.parametrize("protocol", ["tcp", "udp"])
def test_priced_hops_and_span_tree_match_reference(setup, protocol):
    jm, jp, tm, tp, jaes, taes, x = setup
    args = dict(latency_s=0.002, capacity_bps=50e6, interface_bps=100e6, loss_rate=0.05)
    jrec = JRecorder()
    jr = JE.SplitRuntime(jm, jp, 9, ae=jaes[9], channel=JChannel(**args), obs=jrec,
                         protocol=protocol).infer(x, iters=1)
    rec = Recorder()
    tr = TE.SplitRuntime(tm, tp, 9, ae=taes[9], channel=TChannel(**args), obs=rec,
                         protocol=protocol, device="cpu").infer(x, iters=1)
    assert tr.transfer_s == jr.transfer_s > 0
    for key in ("n_packets", "n_transmissions", "loss_fraction"):
        assert tr.meta[key] == jr.meta[key]
    assert tr.trace.dur == pytest.approx(tr.total_s, rel=1e-12)
    assert [s.name for s in tr.trace.walk()] == [s.name for s in jr.trace.walk()]
    assert len(rec.tracer.spans) == len(list(tr.trace.walk()))
    # the port's recorder holds the same spans and metric names as the
    # reference's for the same run
    assert ([(s.name, s.clock, s.tid, s.cat) for s in rec.tracer.spans]
            == [(s.name, s.clock, s.tid, s.cat) for s in jrec.tracer.spans])
    assert rec.metrics.series_names() == jrec.metrics.series_names()
    assert ([len(rec.metrics.timeseries(n)[1]) for n in rec.metrics.series_names()]
            == [len(jrec.metrics.timeseries(n)[1]) for n in jrec.metrics.series_names()])
    hop_bytes = "runtime.hop_bytes{k=0}"
    assert (rec.metrics.timeseries(hop_bytes)[1].tolist()
            == jrec.metrics.timeseries(hop_bytes)[1].tolist())


@pytest.mark.parametrize("masked", [False, True])
def test_split_forward_matches_reference(setup, masked):
    """The f32 SC forward of ``core.bottleneck`` (head, AE, optional UDP
    loss mask on the latent, tail)."""
    jm, jp, tm, tp, jaes, taes, x = setup
    z_shape = (2,) + tuple(jm.activation_shapes(jp, 1)[9][1:-1]) + (
        jaes[9]["enc"]["w"].shape[1],)
    mask = (np.arange(np.prod(z_shape)) % 4 != 1).reshape(z_shape).astype(np.float32)
    jy = JB.split_forward(jm, jp, jaes[9], 9, x, mask if masked else None)
    ty = TB.split_forward(tm, tp, taes[9], 9, torch.tensor(x),
                          torch.tensor(mask) if masked else None)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-5)
    assert TB.payload_bytes(z_shape[1:], 0.5, 1) == JB.payload_bytes(z_shape[1:], 0.5, 1)


def test_run_clients_matches_reference(setup):
    jm, jp, tm, tp, jaes, taes, x = setup
    rng = np.random.default_rng(7)
    clients = [rng.standard_normal((2, 16, 16, 3)).astype(np.float32) for _ in range(3)]
    jres, jsrv = JE.run_clients(jm, jp, 9, clients, ae=jaes[9], n_slots=2)
    tres, tsrv = TE.run_clients(tm, tp, 9, clients, ae=taes[9], n_slots=2, device="cpu")
    assert sorted(tres) == sorted(jres) == [0, 1, 2]
    for cid in tres:
        assert tres[cid].shape == (2, 8)
        assert _rel(tres[cid], np.asarray(jres[cid])) < QUANT_RTOL
    assert (tsrv.n_batches, tsrv.n_served, tsrv.occupancy) == \
        (jsrv.n_batches, jsrv.n_served, jsrv.occupancy)


def _entry_points(tm, tp, taes):
    part = make_partition(tm, tp, 9, device="cpu")
    return {
        "SplitRuntime": lambda: TE.SplitRuntime(tm, tp, 9),
        "TailServer": lambda: TE.TailServer(part),
        "run_clients": lambda: TE.run_clients(tm, tp, 9, [np.zeros((1, 16, 16, 3))]),
        "Partition": lambda: make_partition(tm, tp, 9),
        "init": lambda: tm.init(0),
        "vgg_params_from_numpy": lambda: vgg_params_from_numpy(
            tm, [{k: v.numpy() for k, v in p.items()} for p in tp]),
        "ae_from_numpy": lambda: ae_from_numpy(
            {p: {k: v.numpy() for k, v in d.items()} for p, d in taes[9].items()}),
        "init_bottleneck": lambda: TB.init_bottleneck(0, (4, 4, 16)),
        "ApplicationSimulator": lambda: ApplicationSimulator(
            tm, tp, NetworkConfig("tcp", TChannel(1e-4, 1e9, 1e9))),
        "calibrate": lambda: calibrate(tm, tp, [9]),
    }


@pytest.mark.parametrize("name", ["SplitRuntime", "TailServer", "run_clients", "Partition",
                                  "init", "vgg_params_from_numpy", "ae_from_numpy",
                                  "init_bottleneck", "ApplicationSimulator", "calibrate"])
def test_entry_points_raise_without_cuda_unless_asked_for_cpu(setup, name):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    _, _, tm, tp, _, taes, _ = setup
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points(tm, tp, taes)[name]()
