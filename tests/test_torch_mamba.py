"""The port's Mamba selective scan (its plain version on the CPU) and mixer
against the JAX package: the Pallas kernel in interpret mode, its ``ref``
oracle and ``repro.models.mamba`` on reduced jamba-v0.1-52b with its dense
FFN (``moe=None``)."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mamba_scan import mamba_scan as pallas_scan  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro.models.common import reduced as jreduced  # noqa: E402
from repro_torch.configs import SERVED, get_config  # noqa: E402
from repro_torch.kernels import launch_counts, ops, ref  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan  # noqa: E402
from repro_torch.models import mamba as TM  # noqa: E402
from repro_torch.models.common import reduced  # noqa: E402
from repro_torch.params import _leaf  # noqa: E402

# tests/test_kernels.py's MAMBA_CASES: b, s, di, ds, chunk, bd
MAMBA_CASES = [(2, 64, 128, 16, 32, 64), (1, 128, 256, 16, 128, 256), (2, 32, 64, 8, 16, 64)]
TOL = 1e-4   # as tests/test_kernels.py holds the TPU kernel to its ref
# the mixer in f32: the same arithmetic in another order
F32_TOL = 1e-5
# the mixer in bf16, relative to max |y|: both frameworks round the conv,
# silu and the products to bf16 at the same places, but XLA's sigmoid and
# exp differ from PyTorch's by an ulp here and there (measured up to 1.2% of
# max |y| over init seeds 4-6, dominated by 1-ulp flips of silu)
BF16_RTOL = 3e-2


def _inputs(b, s, di, ds, seed, *, state=False):
    rng = np.random.default_rng(seed)
    dt = 0.1 * np.log1p(np.exp(rng.standard_normal((b, s, di))))
    bm, cm = (0.5 * rng.standard_normal((b, s, ds)) for _ in range(2))
    x = rng.standard_normal((b, s, di))
    a = -np.exp(0.3 * rng.standard_normal((di, ds)))
    st = 0.3 * rng.standard_normal((b, di, ds)) if state else np.zeros((b, di, ds))
    return [v.astype(np.float32) for v in (dt, bm, cm, x, a, st)]


@pytest.mark.parametrize("case", MAMBA_CASES)
def test_plain_scan_matches_pallas_kernel_and_ref_from_zero(case):
    b, s, di, ds, chunk, bd = case
    arrays = _inputs(b, s, di, ds, s + di)
    y, _ = mamba_scan(*(torch.from_numpy(a) for a in arrays))
    j = [jnp.asarray(a) for a in arrays[:5]]
    np.testing.assert_allclose(y.numpy(), np.asarray(pallas_scan(*j, chunk=chunk, bd=bd,
                                                                 interpret=True)), atol=TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jref.mamba_scan_ref(*j)), atol=TOL)


def _fma(a, b, c):
    """a * b + c rounded once to f32, as ``fmaf`` rounds it (through f64,
    where the product of two f32 values is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _scan_kernel_numerics(dt, bm, cm, x, a, state, lanes=2):
    """The arithmetic of ``csrc/mamba_scan.cu``, written out in PyTorch (CPU):
    A scaled by log2 e once; dA = exp2(dt * A'), each product rounded to f32;
    h = fma(dA, h, (dt * x) * B); y as each lane's partial over its
    d_state / lanes entries (a product, then fmas in ascending entry), the
    partials added pairwise as the lanes' xor-shuffles add them.  exp2 here
    is torch's f32 exp2; the kernel's ex2.approx is within 2 ulp of 2^x,
    which this cannot model, so the 1e-5 bar has to hold that too."""
    a2 = a * torch.tensor(math.log2(math.e), dtype=torch.float32)
    b, _, di = dt.shape
    e = a.shape[1] // lanes
    h, ys = state.clone(), []
    for t in range(dt.shape[1]):
        da = torch.exp2(dt[:, t, :, None] * a2)
        h = _fma(da, h, (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :])
        hl = h.view(b, di, lanes, e)
        cl = cm[:, t].reshape(b, 1, lanes, e).expand(b, di, lanes, e)
        p = hl[..., 0] * cl[..., 0]
        for i in range(1, e):
            p = _fma(hl[..., i], cl[..., i], p)
        while p.shape[-1] > 1:          # xor 1, then xor 2, ...
            p = p[..., 0::2] + p[..., 1::2]
        ys.append(p[..., 0])
    return torch.stack(ys, dim=1), h


def _kernel_inputs(served_a, b=2, s=32, di=1024, ds=16, seed=5):
    """Z7's inputs, or the served model's own A, -(1 .. 16) in every channel
    (``models/mamba.py``), with dt = softplus(N(0, 1)) unscaled."""
    dt, bm, cm, x, a, st = _inputs(b, s, di, ds, seed, state=True)
    if served_a:
        z = np.random.default_rng(seed + 1).standard_normal((b, s, di))
        dt = np.log1p(np.exp(z)).astype(np.float32)
        a = -np.broadcast_to(np.arange(1, ds + 1, dtype=np.float32), (di, ds)).copy()
    return dt, bm, cm, x, a, st


# di 1024 is two of the Pallas kernel's 512-channel blocks, S 32 two of its
# 16-step chunks
@pytest.mark.parametrize("served_a", [False, True])
def test_kernel_numerics_match_pallas_kernel_and_plain_scan(served_a):
    """The CUDA kernel's roundings against the Pallas kernel (interpret
    mode, from zero) and the plain scan (from a given state) at 1e-5 of
    max, the bar chip_smoke.py and the card tests hold the kernel to."""
    arrays = _kernel_inputs(served_a)
    dt, bm, cm, x, a, st = (torch.from_numpy(v) for v in arrays)
    if served_a:      # the regime where ex2 of the pre-scaled argument departs most
        assert float((dt[..., None] * a.abs().max()).max()) > 10
    zero = torch.zeros_like(st)
    got, _ = _scan_kernel_numerics(dt, bm, cm, x, a, zero)
    want = np.asarray(pallas_scan(*(jnp.asarray(v) for v in arrays[:5]), chunk=16, bd=512,
                                  interpret=True))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    got_y, got_st = _scan_kernel_numerics(dt, bm, cm, x, a, st)
    want_y, want_st = ref.mamba_scan_ref(dt, bm, cm, x, a, st)
    assert float((got_y - want_y).abs().max()) <= 1e-5 * float(want_y.abs().max())
    assert float((got_st - want_st).abs().max()) <= 1e-5 * float(want_st.abs().max())


def test_final_state_is_the_reference_mixers_state():
    """From zero, the final state equals the one ``repro.models.mamba``
    carries out of its scan: run the reference recurrence by hand."""
    dt, bm, cm, x, a, st = _inputs(2, 9, 32, 16, 1)
    _, final = mamba_scan(*(torch.from_numpy(v) for v in (dt, bm, cm, x, a, st)))
    h = np.zeros_like(st, dtype=np.float64)
    for t in range(dt.shape[1]):
        h = (np.exp(dt[:, t, :, None] * a) * h
             + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :])
    np.testing.assert_allclose(final.numpy(), h, atol=1e-6)


@pytest.mark.parametrize("s", [1, 37])
def test_scan_splits_at_any_step(s):
    """Two runs chained through the state equal one run: how decode carries
    the prefill's state, and how a given state enters the scan."""
    dt, bm, cm, x, a, st = (torch.from_numpy(v) for v in _inputs(2, s + 5, 48, 16, s,
                                                                   state=True))
    y, final = mamba_scan(dt, bm, cm, x, a, st)
    cut = s
    y1, s1 = mamba_scan(*(v[:, :cut].contiguous() for v in (dt, bm, cm, x)), a, st)
    y2, s2 = mamba_scan(*(v[:, cut:].contiguous() for v in (dt, bm, cm, x)), a, s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=0, atol=1e-6)
    torch.testing.assert_close(s2, final, rtol=0, atol=1e-6)


def test_cpu_scan_launches_nothing_and_checks_inputs():
    dt, bm, cm, x, a, st = (torch.from_numpy(v) for v in _inputs(1, 4, 16, 16, 0))
    before = launch_counts()
    y, final = ops.mamba_scan_op(dt, bm, cm, x, a)     # zero state, as the reference's op
    want_y, want_final = mamba_scan(dt, bm, cm, x, a, st)
    assert torch.equal(y, want_y) and torch.equal(final, want_final)
    assert launch_counts() == before
    with pytest.raises(ValueError, match="at least one step"):
        mamba_scan(dt[:, :0], bm[:, :0], cm[:, :0], x[:, :0], a, st)
    with pytest.raises(ValueError, match="want dt"):
        mamba_scan(dt[0], bm, cm, x, a, st)
    with pytest.raises(ValueError, match="shape mismatch"):
        mamba_scan(dt, bm, cm, x[:, :3].contiguous(), a, st)
    with pytest.raises(ValueError, match="want b, c"):
        mamba_scan(dt, bm[:, :3].contiguous(), cm, x, a, st)
    with pytest.raises(ValueError, match="want a"):
        mamba_scan(dt, bm, cm, x, a[:8].contiguous(), st)
    with pytest.raises(ValueError, match="want a"):
        mamba_scan(dt, bm, cm, x, a, st[:, :8].contiguous())
    with pytest.raises(TypeError, match="float32"):
        mamba_scan(dt.double(), bm, cm, x, a, st)
    with pytest.raises(TypeError, match="float32"):
        mamba_scan(dt, bm, cm, x, a, st.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan(dt, bm, cm, x, a.t().contiguous().t(), st)
    with pytest.raises(ValueError, match="is on meta"):
        mamba_scan(dt, bm, cm, x, a, st.to("meta"))
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        mamba_scan(*(v.to("meta") for v in (dt, bm, cm, x, a, st)))
    assert launch_counts() == before


def _mixer(dtype, seed=4):
    served = SERVED["jamba-v0.1-52b"]
    cfg = dataclasses.replace(reduced(get_config("jamba-v0.1-52b")), dtype=dtype, **served)
    jcfg = dataclasses.replace(jreduced(jget_config("jamba-v0.1-52b")), dtype=dtype, **served)
    jp = JM.init_mamba(jax.random.PRNGKey(seed), jcfg)
    tp = {k: _leaf(np.asarray(a), "cpu") for k, a in jp.items()}
    return cfg, jcfg, tp, jp


def _state(cfg, b, seed):
    """A given (conv, ssm) decode state, f32 as the cache keeps it."""
    rng = np.random.default_rng(seed)
    di, ds, dc = TM.d_inner(cfg), cfg.mamba_d_state, cfg.mamba_d_conv
    return (rng.standard_normal((b, dc - 1, di)).astype(np.float32),
            (0.1 * rng.standard_normal((b, di, ds))).astype(np.float32))


def _bits(a):
    """A numpy or JAX array in the port's dtype (bf16 crosses as its bits)."""
    return _leaf(np.asarray(a), "cpu")


def _compare(got, want, dtype):
    """y, conv state and ssm state of the port against the reference's."""
    for g, w in zip(got, want):
        g, w = g.float().numpy(), np.asarray(jnp.asarray(w).astype(jnp.float32))
        assert g.shape == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
        else:
            assert np.abs(g - w).max() <= BF16_RTOL * np.abs(w).max()


# S 131: no multiple of the reference's chunk of 128 (it falls back to 1)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s, given", [(24, False), (131, False), (17, True)])
def test_mamba_seq_matches_reference(dtype, s, given):
    cfg, jcfg, tp, jp = _mixer(dtype)
    jdt = jnp.dtype(dtype)
    x = jnp.asarray(np.random.default_rng(s).standard_normal((2, s, cfg.d_model)), jdt)
    st = _state(cfg, 2, s) if given else None
    y, (conv, ssm) = TM.mamba_seq(tp, _bits(x), cfg,
                                  None if st is None else tuple(map(torch.from_numpy, st)))
    jy, (jconv, jssm) = JM.mamba_seq(jp, x, jcfg,
                                     None if st is None else tuple(map(jnp.asarray, st)))
    assert y.dtype == cfg.tdtype and conv.dtype == ssm.dtype == torch.float32
    _compare((y, conv, ssm), (jy, jconv, jssm), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("given", [False, True])
def test_mamba_step_matches_reference(dtype, given):
    cfg, jcfg, tp, jp = _mixer(dtype)
    jdt = jnp.dtype(dtype)
    if given:
        st = _state(cfg, 3, 7)
    else:      # the port's zero state is the reference's
        st = tuple(a.numpy() for a in TM.init_state(cfg, 3, "cpu"))
        for a, ja in zip(st, JM.init_state(jcfg, 3)):
            np.testing.assert_array_equal(a, np.asarray(ja))
    x = jnp.asarray(np.random.default_rng(8).standard_normal((3, 1, cfg.d_model)), jdt)
    got = TM.mamba_step(tp, _bits(x), tuple(map(torch.from_numpy, st)), cfg)
    want = JM.mamba_step(jp, x, tuple(map(jnp.asarray, st)), jcfg)
    _compare((got[0], *got[1]), (want[0], *want[1]), dtype)


def test_steps_continue_the_sequence():
    """mamba_seq over a prompt, then mamba_step token by token, gives what
    one mamba_seq over the whole sequence gives (f32)."""
    cfg, _, tp, _ = _mixer("float32")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 12, cfg.d_model))
                         .astype(np.float32))
    y, (conv, ssm) = TM.mamba_seq(tp, x, cfg)
    y1, state = TM.mamba_seq(tp, x[:, :8], cfg)
    steps = [y1]
    for t in range(8, 12):
        yt, state = TM.mamba_step(tp, x[:, t:t + 1], state, cfg)
        steps.append(yt)
    torch.testing.assert_close(torch.cat(steps, 1), y, rtol=F32_TOL, atol=F32_TOL)
    torch.testing.assert_close(state[0], conv, rtol=0, atol=0)
    torch.testing.assert_close(state[1], ssm, rtol=F32_TOL, atol=F32_TOL)


def _mixer_by_hand(p, x, state, cfg, *, step, skip=None):
    """The reference's mixer (``repro/models/mamba.py``, ``mamba_seq`` or,
    with ``step``, ``mamba_step``) written out in torch, rounding to the
    model dtype where the reference does; ``skip`` leaves one rounding out,
    as a port that missed it would: "conv" sums the taps in f32, "silu"
    keeps the conv output in f32, "gate" does not round y before the gate.
    The scan is the port's plain loop: the casts around it are under test."""
    md, f32 = x.dtype, torch.float32
    dc, ds = cfg.mamba_d_conv, cfg.mamba_d_state
    s = x.shape[1]
    xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    xp = torch.cat([state[0].to(md), xi], dim=1)
    wide = f32 if skip == "conv" else md
    conv, conv_b = p["conv"].to(wide), p["conv_b"].to(wide)
    if step:
        xc = torch.einsum("bcd,cd->bd", xp.to(wide), conv)[:, None] + conv_b
    else:
        xc = sum(xp[:, i:i + s].to(wide) * conv[i] for i in range(dc)) + conv_b
    xc = F.silu(xc.to(f32) if skip == "silu" else xc.to(md))
    proj = (xc @ p["x_proj"].to(xc.dtype)).to(f32)
    dt_r, bm, cm = torch.split(proj, [TM.DT_RANK, ds, ds], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"])
    y, h = ref.mamba_scan_ref(dt, bm.contiguous(), cm.contiguous(), xc.to(f32),
                              -torch.exp(p["A_log"]), state[1])
    y = y + p["D"] * xc.to(f32)
    gated = y * F.silu(z) if skip == "gate" else y.to(md) * F.silu(z)
    out = (gated @ p["out_proj"].to(gated.dtype)).to(md)
    return out, xp[:, -(dc - 1):].to(f32), h


# bf16 against the reference's casts bit for bit (the JAX comparison above
# cannot see a missed cast: it moves y by about one bf16 ulp, well inside
# BF16_RTOL); each skipped rounding must change the result
@pytest.mark.parametrize("skip", ["conv", "silu", "gate"])
@pytest.mark.parametrize("step", [False, True])
def test_bf16_mixer_rounds_where_the_reference_does(step, skip):
    cfg, _, tp, _ = _mixer("bfloat16")
    gen = torch.Generator().manual_seed(5)
    # a conv bias as a trained model has (init makes it zero), so that its
    # sum rounds too
    tp["conv_b"] = (0.1 * torch.randn(tp["conv_b"].shape, generator=gen)).to(torch.bfloat16)
    s = 1 if step else 17
    x = torch.randn((2, s, cfg.d_model), generator=gen).to(torch.bfloat16)
    st = tuple(map(torch.from_numpy, _state(cfg, 2, 9)))
    got = TM.mamba_step(tp, x, st, cfg) if step else TM.mamba_seq(tp, x, cfg, st)
    got = (got[0], *got[1])
    want = _mixer_by_hand(tp, x, st, cfg, step=step)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    missed = _mixer_by_hand(tp, x, st, cfg, step=step, skip=skip)
    assert not torch.equal(got[0], missed[0])


def test_init_mamba_has_the_reference_leaves():
    for dtype in ("float32", "bfloat16"):
        cfg, _, _, jp = _mixer(dtype)
        p = TM.init_mamba(torch.Generator().manual_seed(0), cfg, torch.device("cpu"))
        assert set(p) == set(jp)
        for k, a in jp.items():
            assert tuple(p[k].shape) == a.shape and p[k].dtype == _bits(a).dtype, k
        for k in ("dt_bias", "A_log", "D", "conv_b"):
            np.testing.assert_allclose(p[k].float().numpy(), np.asarray(jp[k], np.float32),
                                       rtol=1e-6)


def test_jamba_bf16_leaves_cross_in_their_own_dtypes():
    """A bf16 jamba's Mamba leaves cross bit for bit: dt_proj, dt_bias, A_log
    and D stay f32; in_proj, conv, conv_b, x_proj and out_proj are bf16."""
    from repro.models import transformer as JT
    from repro_torch.params import transformer_params_from_numpy
    cfg, jcfg, _, _ = _mixer("bfloat16")
    jp = JT.init_params(jax.random.PRNGKey(2), jcfg)
    tp = transformer_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    mixers = [j for j in range(8) if "mamba" in tp["layers"][f"l{j}"]]
    assert mixers == [0, 1, 2, 3, 5, 6, 7]
    for j in mixers:
        got, want = tp["layers"][f"l{j}"]["mamba"], jp["layers"][f"l{j}"]["mamba"]
        for k, a in want.items():
            f32 = k in ("dt_proj", "dt_bias", "A_log", "D")
            assert got[k].dtype == (torch.float32 if f32 else torch.bfloat16), k
            a = np.asarray(a)
            bits = got[k].view(torch.int32 if f32 else torch.int16).numpy()
            np.testing.assert_array_equal(bits, a.view(bits.dtype))
