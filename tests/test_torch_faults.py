"""The port's fault layer (``runtime/faults.py``) and the recovery half of
its split runtime (``SplitRuntime(faults=, recovery=)``, ``TailServer(faults=)``)
against the JAX package, on the small VGG of ``tests/conftest.py`` with its
weights and AE drawn with numpy in the reference's tree.

Bars, fixed before measuring: the fault plan's draws, corruptions and the
policy's timeouts and backoffs equal the reference's exactly (the same numpy
draws); each request's recovery record equals the reference's field by field
(fault counts, retries, timeouts, backoff seconds, downgrades, the corrupt
log, each hop's attempts, rung, delivery, bytes and event names, and every
event priced from the plan or the channel), leaving out only the seconds
measured on the host (stage, encode and decode times, and the virtual clock
that sums them); the logits within ``QUANT_RTOL`` of max |logit| of the
reference's, as ``tests/test_torch_runtime.py`` holds the quantised wire
kinds (the C2 parity bar: a code may move by one at a rounding tie).

The plans keep every fate away from the measured seconds: the chaos plan
has no deadline, the blackout covers all time, and the deadline plan checks
its 1 s deadline after the encode, then near 0.55 s and near 1.6 s (each
attempt a 0.02 s timeout and a backoff from 0.5 s, doubling, with up to 10%
jitter): the stages and codec, milliseconds warm and more on a cold first
call, would have to take over 0.4 s to move a fate.
4.9 s of test time in a 6-worker run of the whole suite.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data.synthetic import toy_images  # noqa: E402
from repro.models import vgg as jvgg  # noqa: E402
from repro.netsim.channel import Channel as JChannel  # noqa: E402
from repro.runtime import engine as JE  # noqa: E402
from repro.runtime import faults as JF  # noqa: E402
from repro.runtime import wire as JW  # noqa: E402
from repro.runtime.partition import make_partition as j_make_partition  # noqa: E402
from repro_torch.models import vgg as tvgg  # noqa: E402
from repro_torch.netsim.channel import Channel as TChannel  # noqa: E402
from repro_torch.params import ae_from_numpy, vgg_params_from_numpy  # noqa: E402
from repro_torch.runtime import engine as TE  # noqa: E402
from repro_torch.runtime import faults as TF  # noqa: E402
from repro_torch.runtime import wire as TW  # noqa: E402
from repro_torch.runtime.partition import make_partition as t_make_partition  # noqa: E402
from test_torch_simulator import he_normal_like, numpy_ae  # noqa: E402

AE_CUT, INT8_CUT = 4, 3          # pool4 (8, 8, 8) with an AE; relu3 on int8
CH = dict(latency_s=0.005, capacity_bps=50e6, interface_bps=100e6,
          loss_rate=0.02, seed=3)
QUANT_RTOL = 1e-3
# (plan, policy) keyword pairs, each run at both cuts, eager and fused
PLANS = {
    "chaos": (dict(seed=7, drop_rate=0.35, corrupt_rate=0.25,
                   straggle_rate=0.1, straggle_s=0.01),
              dict(max_attempts=6, downgrade_after=2)),
    "corrupt": (dict(seed=1, corrupt_rate=0.95, max_consecutive=10),
                dict(downgrade_after=2, max_attempts=12)),
    "blackout": (dict(seed=2, blackouts=((0.0, 1e9),)),
                 dict(max_attempts=3)),
    "stage": (dict(seed=3, stage_fault_rate=0.6, max_consecutive=4), {}),
    "deadline": (dict(seed=4, drop_rate=1.0, max_consecutive=100),
                 dict(deadline_s=1.0, base_backoff_s=0.5, backoff_cap_s=2.0,
                      max_attempts=100)),
}
RIDS = {"chaos": (0, 1, 2, 3)}
# events whose seconds the host measures; every other event is priced
MEASURED = {"encode", "re-encode", "decode"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module (six test processes
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rig():
    """One reference runtime a cut (its stages compile once; the plan and
    policy are swapped per case), the port's params and AE, 2 images."""
    jm = jvgg.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
    tm = tvgg.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
    p_np = he_normal_like(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 0)
    c = tm.activation_shapes(tm.init(0, device="cpu"), 1)[AE_CUT][-1]
    ae_np = numpy_ae(c, 10 + AE_CUT)
    jp = jax.tree.map(jnp.asarray, p_np)
    jae = jax.tree.map(jnp.asarray, ae_np)
    tp = vgg_params_from_numpy(tm, p_np, device="cpu")
    tae = ae_from_numpy(ae_np, device="cpu")
    jch, tch = JChannel(**CH), TChannel(**CH)
    ref = {AE_CUT: JE.SplitRuntime(jm, jp, AE_CUT, ae=jae, channel=jch),
           INT8_CUT: JE.SplitRuntime(jm, jp, INT8_CUT, channel=jch)}
    x = toy_images(2, hw=16, seed=5)[0]
    return {"jm": jm, "jp": jp, "tm": tm, "tp": tp, "ref": ref,
            "aes": {AE_CUT: tae, INT8_CUT: None}, "tch": tch, "x": x,
            "jref_out": {}}


def _ref_run(rig, cut, name, rid):
    """The reference's result for (cut, plan, rid), computed once."""
    key = (cut, name, rid)
    if key not in rig["jref_out"]:
        plan_kw, pol_kw = PLANS[name]
        rt = rig["ref"][cut]
        rt.faults = JF.FaultPlan(**plan_kw)
        rt.recovery = JF.RecoveryPolicy(**pol_kw)
        rig["jref_out"][key] = rt.infer(jnp.asarray(rig["x"]), iters=1, rid=rid)
    return rig["jref_out"][key]


def _hop_view(h):
    """A hop's record without the seconds the host measures."""
    out = {k: v for k, v in h.items()
           if k not in ("encode_s", "transfer_s", "decode_s", "events")}
    out["events"] = [(n, b) if n in MEASURED else (n, b, d)
                     for n, b, d in h["events"]]
    out["transfer_s"] = sum(d for n, b, d in h["events"]
                            if b == "transfer")
    return out


def _rec_view(meta):
    rec = dict(meta["recovery"])
    rec.pop("t_virtual_s")
    return {"degraded": meta["degraded"],
            "local_fallback": meta["local_fallback"], "recovery": rec}


# ---------------------------------------------------------- fault plan ----
def test_plan_draws_and_policy_equal_the_reference():
    kw = dict(seed=11, drop_rate=0.3, corrupt_rate=0.2, straggle_rate=0.1,
              stage_fault_rate=0.25, blackouts=((0.1, 0.2), (0.5, 0.6)),
              max_consecutive=5)
    jp, tp = JF.FaultPlan(**kw), TF.FaultPlan(**kw)
    for rid in range(4):
        for hop in range(3):
            assert (tp.transfer_schedule(rid, hop, 8)
                    == jp.transfer_schedule(rid, hop, 8))
            assert ([tp.stage_fault(rid, hop, a) for a in range(8)]
                    == [jp.stage_fault(rid, hop, a) for a in range(8)])
            buf = bytes(range(200))
            for a in range(3):
                assert (tp.corrupt_bytes(buf, rid, hop, a, lo=20)
                        == jp.corrupt_bytes(buf, rid, hop, a, lo=20))
    for t in (0.0, 0.15, 0.2, 0.55, 1.0):
        assert tp.blackout_at(t) == jp.blackout_at(t)
        assert tp.blackout_end(t) == jp.blackout_end(t)
    assert tp.any_faults and not TF.FaultPlan().any_faults
    with pytest.raises(ValueError, match="empty"):
        TF.FaultPlan(blackouts=((0.2, 0.1),))
    jch, tch = JChannel(**CH), TChannel(**CH)
    pols = [dict(), dict(base_backoff_s=0.01, backoff_mult=3.0,
                         backoff_cap_s=0.05, jitter=0.3)]
    for kw in pols:
        jpol, tpol = JF.RecoveryPolicy(**kw), TF.RecoveryPolicy(**kw)
        assert tpol.rto_s(tch) == jpol.rto_s(jch)
        assert tpol.timeout_s(tch, 12345) == jpol.timeout_s(jch, 12345)
        assert tpol.timeout_s(None, 10) == jpol.timeout_s(None, 10)
        for a in range(8):
            for ch_pair in ((tch, jch), (None, None)):
                assert (tpol.backoff_s(a, seed=3, rid=2, hop=1,
                                       channel=ch_pair[0])
                        == jpol.backoff_s(a, seed=3, rid=2, hop=1,
                                          channel=ch_pair[1]))
    for kind in ("ae8", "int8", "f32"):
        assert TF.downgrade_ladder(kind) == JF.downgrade_ladder(kind)


# ------------------------------------------------------------ recovery ----
CASES = [(cut, name, rid) for cut in (AE_CUT, INT8_CUT) for name in PLANS
         for rid in RIDS.get(name, (0,))]


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
@pytest.mark.parametrize("cut,name,rid", CASES,
                         ids=[f"{c}-{n}-{r}" for c, n, r in CASES])
def test_recovery_record_equals_the_reference(rig, cut, name, rid, fused):
    plan_kw, pol_kw = PLANS[name]
    want = _ref_run(rig, cut, name, rid)
    rt = TE.SplitRuntime(rig["tm"], rig["tp"], cut, ae=rig["aes"][cut],
                         channel=rig["tch"], fused=fused,
                         faults=TF.FaultPlan(**plan_kw),
                         recovery=TF.RecoveryPolicy(**pol_kw), device="cpu")
    got = rt.infer(rig["x"], iters=1, rid=rid)
    assert got.meta["fused"] is fused
    assert got.meta["recovery"]["exec"] == "eager"
    assert _rec_view(got.meta) == _rec_view(want.meta)
    assert [_hop_view(h) for h in got.hops] == [_hop_view(h) for h in want.hops]
    assert got.wire_bytes == want.wire_bytes
    assert len(got.stage_s) == len(want.stage_s)
    # the span tree reconciles with the total, as the reference's does
    assert got.trace.dur == pytest.approx(got.total_s, rel=1e-9)
    assert [s.name for s in got.trace.walk()] == [s.name for s in want.trace.walk()]
    jl = np.asarray(want.logits)
    assert float(np.abs(got.logits - jl).max() / np.abs(jl).max()) <= QUANT_RTOL


def test_the_plans_reach_every_rung(rig):
    """The cases above take every path: a retry that stays bit-identical, a
    downgrade on each ladder, the local fallback by attempts and by the
    deadline, stage faults, stragglers."""
    seen = {(cut, name): _ref_run(rig, cut, name, 0).meta["recovery"]
            for cut in (AE_CUT, INT8_CUT) for name in PLANS}
    assert seen[AE_CUT, "corrupt"]["downgrades"][0]["to"] == "int8"
    assert seen[INT8_CUT, "corrupt"]["downgrades"][0]["to"] == "f32"
    assert seen[AE_CUT, "blackout"]["local_fallback"]
    assert seen[AE_CUT, "deadline"]["local_fallback"]
    assert seen[AE_CUT, "deadline"]["faults"]["drop"] == 2
    assert seen[AE_CUT, "stage"]["faults"]["stage"] > 0
    chaos = [_ref_run(rig, AE_CUT, "chaos", r).meta["recovery"] for r in RIDS["chaos"]]
    for kind in ("drop", "corrupt", "straggle"):
        assert sum(c["faults"][kind] for c in chaos) > 0, kind


def test_retried_and_fallen_back_logits(rig):
    """A retried request's logits equal the clean run's bit for bit; the
    local fallback skips the codec, so it equals the unsplit model."""
    tm, tp, x = rig["tm"], rig["tp"], rig["x"]
    ae = rig["aes"][AE_CUT]
    clean = TE.SplitRuntime(tm, tp, AE_CUT, ae=ae, channel=rig["tch"],
                            device="cpu").infer(x, iters=1)
    retried = TE.SplitRuntime(tm, tp, AE_CUT, ae=ae, channel=rig["tch"],
                              faults=TF.FaultPlan(seed=7, drop_rate=0.5),
                              device="cpu").infer(x, iters=1, rid=0)
    assert retried.meta["recovery"]["retries"] > 0 and not retried.meta["degraded"]
    assert np.array_equal(retried.logits, clean.logits)
    assert retried.transfer_s > clean.transfer_s
    plan_kw, pol_kw = PLANS["blackout"]
    rt = TE.SplitRuntime(tm, tp, AE_CUT, ae=ae, channel=rig["tch"],
                         faults=TF.FaultPlan(**plan_kw),
                         recovery=TF.RecoveryPolicy(**pol_kw), device="cpu")
    fell = rt.infer(x, iters=1, rid=0)
    assert fell.meta["local_fallback"] and not fell.hops[0]["delivered"]
    np.testing.assert_allclose(fell.logits, rt.reference(x), rtol=1e-5, atol=1e-5)


def test_zero_fault_frames_stay_sei1(rig):
    """``faults=None`` keeps the SEI1 layout byte for byte (the reference's
    framing of the same arrays), and the runtime with a plan that injects
    nothing gives the clean run's logits."""
    tm, tp, x = rig["tm"], rig["tp"], rig["x"]
    for cut in (AE_CUT, INT8_CUT):
        ae = rig["aes"][cut]
        part = t_make_partition(tm, tp, cut, ae, device="cpu")
        pkt = TW.encode_activation(part.stage(0)(torch.from_numpy(x)), ae)
        buf = TW.to_bytes(pkt)
        assert buf[:4] == b"SEI1"
        assert buf == JW.frame_arrays(pkt.kind, pkt.data, pkt.scales, checksum=False)
        clean = TE.SplitRuntime(tm, tp, cut, ae=ae, device="cpu")
        assert clean.faults is None
        r0 = clean.infer(x, iters=1)
        r1 = TE.SplitRuntime(tm, tp, cut, ae=ae, fused=True,
                             device="cpu").infer(x, iters=1)
        assert np.array_equal(r0.logits, r1.logits)
        assert "recovery" not in r0.meta
        quiet = TE.SplitRuntime(tm, tp, cut, ae=ae, faults=TF.FaultPlan(seed=9),
                                device="cpu").infer(x, iters=1, rid=3)
        assert np.array_equal(quiet.logits, r0.logits)
        assert quiet.meta["recovery"]["retries"] == 0


def test_exhaustion_without_fallback_raises(rig):
    rt = TE.SplitRuntime(rig["tm"], rig["tp"], INT8_CUT, channel=rig["tch"],
                         faults=TF.FaultPlan(seed=4, drop_rate=1.0, max_consecutive=100),
                         recovery=TF.RecoveryPolicy(max_attempts=3, local_fallback=False),
                         device="cpu")
    with pytest.raises(TF.RecoveryExhausted):
        rt.infer(rig["x"], iters=1, rid=0)


def test_fault_counters_equal_the_reference(rig):
    """The ``runtime.fault.*`` / ``runtime.retry.*`` counters of the port's
    recorder equal the reference recorder's for the same request."""
    from repro.obs import Recorder as JRecorder
    from repro_torch.obs import Recorder as TRecorder
    plan_kw, pol_kw = PLANS["chaos"]
    counters = []
    for rec, rt in (
            (JRecorder(), lambda o: JE.SplitRuntime(
                rig["jm"], rig["jp"], INT8_CUT, channel=JChannel(**CH), obs=o,
                faults=JF.FaultPlan(**plan_kw), recovery=JF.RecoveryPolicy(**pol_kw))),
            (TRecorder(), lambda o: TE.SplitRuntime(
                rig["tm"], rig["tp"], INT8_CUT, channel=rig["tch"], obs=o,
                faults=TF.FaultPlan(**plan_kw), recovery=TF.RecoveryPolicy(**pol_kw),
                device="cpu"))):
        x = rig["x"] if isinstance(rec, TRecorder) else jnp.asarray(rig["x"])
        run = rt(rec)
        for rid in RIDS["chaos"]:
            run.infer(x, iters=1, rid=rid)
        counters.append(rec.report().counters())
        assert rec.metrics.series_names() and rec.tracer.spans
    assert counters[0] == counters[1]
    assert counters[1]["runtime.retry.attempts"] > 0


# ---------------------------------------------------------- tail server ----
def _server_pair(rig, plan_kw):
    jpart = j_make_partition(rig["jm"], rig["jp"], INT8_CUT, None)
    tpart = t_make_partition(rig["tm"], rig["tp"], INT8_CUT, None, device="cpu")
    js = JE.TailServer(jpart, n_slots=2, client_batch=2, faults=JF.FaultPlan(**plan_kw))
    ts = TE.TailServer(tpart, n_slots=2, client_batch=2, faults=TF.FaultPlan(**plan_kw),
                       device="cpu")
    return jpart, tpart, js, ts


def test_tail_server_rejects_corrupted_frames_as_the_reference(rig):
    jpart, tpart, js, ts = _server_pair(rig, dict(seed=0))
    x = rig["x"]
    jgood = JW.to_bytes(JW.encode_activation(jpart.head(jnp.asarray(x))), checksum=True)
    tgood = TW.to_bytes(TW.encode_activation(tpart.head(torch.from_numpy(x))),
                        checksum=True)
    outs = []
    for srv, good, plan in ((js, jgood, js.faults), (ts, tgood, ts.faults)):
        lo = 6 + 4 * good[5] + 8
        res = [srv.submit(0, good), srv.submit(1, plan.corrupt_bytes(good, 0, 0, 0, lo=lo)),
               srv.submit(2, plan.corrupt_bytes(good, 1, 0, 0, lo=lo)), srv.submit(3, good)]
        out = srv.drain()
        outs.append((res, srv.n_rejected, srv.rejected, sorted(out), srv.n_batches, out))
    (jres, jn, jrej, jids, jb, jout), (tres, tn, trej, tids, tb, tout) = outs
    assert (tres, tn, trej, tids, tb) == (jres, jn, jrej, jids, jb)
    assert tres == [True, False, False, True]
    for cid in tids:
        jl = np.asarray(jout[cid])
        assert float(np.abs(tout[cid] - jl).max() / np.abs(jl).max()) <= QUANT_RTOL


def test_tail_server_blackout_as_the_reference(rig):
    jpart, tpart, js, ts = _server_pair(rig, dict(blackouts=((1.0, 2.0),)))
    x = rig["x"]
    js.submit(0, JW.to_bytes(JW.encode_activation(jpart.head(jnp.asarray(x)))))
    ts.submit(0, TW.to_bytes(TW.encode_activation(tpart.head(torch.from_numpy(x)))))
    for now in (1.0, 1.5, 1.999):
        assert ts.step(now=now) == {} and js.step(now=now) == {}
    assert ts.n_blackout_steps == js.n_blackout_steps == 3
    got, want = ts.step(now=2.0), js.step(now=2.0)
    assert sorted(got) == sorted(want) == [0]
    jl = np.asarray(want[0])
    assert float(np.abs(got[0] - jl).max() / np.abs(jl).max()) <= QUANT_RTOL
    # without a plan, ``now`` changes nothing
    plain = TE.TailServer(tpart, n_slots=2, client_batch=2, device="cpu")
    plain.submit(0, TW.to_bytes(TW.encode_activation(tpart.head(torch.from_numpy(x)))))
    assert sorted(plain.step(now=1.5)) == [0] and plain.n_blackout_steps == 0
