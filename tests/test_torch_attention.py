"""The port's flash attention (its plain version on the CPU) and attention
layers against the JAX package: the Pallas kernel in interpret mode, its
``ref`` oracle and ``repro.models.layers``; the bf16 CUDA kernels' forward
and backward arithmetic, written out in PyTorch, against the same."""
import pytest

torch = pytest.importorskip("torch")

import math  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import launch_counts, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,  # noqa: E402
                                                 flash_attention_lse)
from repro_torch.models import layers as TL  # noqa: E402
from test_torch_backward import FLASH_SHAPES as BWD_SHAPES  # noqa: E402

# tests/test_kernels.py's FLASH_CASES: b, sq, sk, h, kh, d, causal, window, dtype
FLASH_CASES = [
    (2, 256, 256, 4, 2, 64, True, None, "float32"),
    (1, 128, 512, 4, 4, 128, True, None, "float32"),
    (2, 256, 256, 8, 2, 64, True, 128, "float32"),
    (1, 256, 256, 2, 1, 64, False, None, "float32"),
    (1, 256, 256, 4, 1, 64, True, None, "bfloat16"),
    (1, 512, 512, 2, 2, 128, True, 256, "float32"),
]
# ragged lengths and Sq < Sk, which the Pallas kernel (whole tiles) does not take
RAGGED_CASES = [
    (2, 77, 77, 4, 2, 32, True, None, "float32"),
    (1, 200, 200, 4, 1, 64, True, 64, "float32"),
    (1, 50, 130, 4, 2, 64, True, None, "float32"),
    (2, 33, 100, 2, 2, 32, False, 40, "float32"),
    (1, 200, 200, 4, 2, 64, True, None, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # as tests/test_kernels.py holds the TPU kernel


def _qkv(case, seed):
    b, sq, sk, h, kh, d, _, _, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, kh, d)).astype(np.float32),
            rng.standard_normal((b, sk, kh, d)).astype(np.float32))


def _both(arrays, dtype):
    """The same values as jax arrays and torch tensors of ``dtype`` (both
    round f32 to bf16 to nearest even, so the bits agree)."""
    jx = [jnp.asarray(a, dtype) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_plain_flash_matches_pallas_kernel_and_ref(case):
    *_, causal, window, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(case, sum(case[:6])), dtype)
    got = _np(flash_attention(tq, tk, tv, causal=causal, window=window))
    pallas = _np(pallas_flash(jq, jk, jv, causal=causal, window=window, interpret=True))
    want = _np(jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window))
    np.testing.assert_allclose(got, pallas, atol=TOL[dtype])
    np.testing.assert_allclose(got, want, atol=TOL[dtype])


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_plain_flash_matches_ref_at_ragged_lengths(case):
    *_, causal, window, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(case, 7), dtype)
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = _np(jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window))
    np.testing.assert_allclose(_np(got), want, atol=TOL[dtype])


# the mask-edge probe (ref.flash_edge_probe) on whole tiles, at each mask:
# b, sq, sk, h, kh, d, causal, window, rising.  Rising scores pick each row's
# last live key (the causal edge, or Sk - 1 without it), falling ones its
# first (the window's edge, or key 0 without it).
PROBE_CASES = [
    (1, 256, 256, 4, 2, 128, True, None, True),
    (1, 256, 256, 4, 2, 128, True, 100, True),
    (1, 256, 256, 4, 2, 128, True, 100, False),
    (1, 128, 384, 4, 2, 128, True, None, True),
    (1, 256, 256, 2, 1, 128, False, 77, False),
    (1, 256, 256, 2, 1, 128, False, None, True),
]


def _probe_keys(sq, sk, causal, window, rising):
    """Each row's picked key and, where the row sees two keys or more, the
    key next to it inside the mask (what an edge off by one would pick)."""
    qp = np.arange(sq) + (sk - sq)
    hi = qp if causal else np.full(sq, sk - 1)
    lo = np.maximum(qp - window + 1, 0) if window else np.zeros(sq, np.int64)
    pick, step = (hi, -1) if rising else (lo, 1)
    return pick, (pick + step)[hi > lo], hi > lo


@pytest.mark.parametrize("case", PROBE_CASES)
def test_plain_flash_matches_pallas_kernel_and_ref_at_mask_edges(case):
    b, sq, sk, h, kh, d, causal, window, rising = case
    tq, tk, tv = ref.flash_edge_probe(b, sq, sk, h, kh, d, rising=rising, seed=sq + sk)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tq, tk, tv))
    got = _np(flash_attention(tq, tk, tv, causal=causal, window=window))
    pallas = _np(pallas_flash(jq, jk, jv, causal=causal, window=window, interpret=True))
    want = _np(jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window))
    np.testing.assert_allclose(got, pallas, atol=TOL["bfloat16"])
    np.testing.assert_allclose(got, want, atol=TOL["bfloat16"])
    # each row is the v row of its picked key; the key next to it is far off
    vh = np.repeat(_np(tv), h // kh, axis=2)
    pick, beside, many = _probe_keys(sq, sk, causal, window, rising)
    np.testing.assert_allclose(got, vh[:, pick], atol=TOL["bfloat16"])
    assert np.abs(vh[:, beside] - vh[:, pick[many]]).max() > 50 * TOL["bfloat16"]


def _wgmma_kernel_numerics(q, k, v, *, causal, window, bq=128, bk=128):
    """The arithmetic of the bf16 CUDA kernel, written out in PyTorch (CPU):
    bq-query blocks over the key range the block can see, in bk-key tiles;
    f32 scores of the bf16 inputs, scaled by scale * log2 e, exp2; P rounded
    to bf16 for the P.V product, its row sum and the accumulator f32."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    k = torch.repeat_interleave(k, h // kh, dim=2).float()
    v = torch.repeat_interleave(v, h // kh, dim=2).float()
    scale_log2 = torch.tensor(math.log2(math.e) / math.sqrt(d), dtype=torch.float32)
    out = torch.empty((b, sq, h, d), dtype=torch.float32)
    for q0 in range(0, sq, bq):
        rows = torch.arange(q0, min(q0 + bq, sq))
        qp = rows + (sk - sq)
        k_end = min(sk, int(qp[-1]) + 1) if causal else sk
        k_begin = max(0, int(qp[0]) - window + 1) // bk * bk if window else 0
        qt = q[:, rows].float()
        m = torch.full((b, h, len(rows)), -1e30)
        l = torch.zeros((b, h, len(rows)))
        acc = torch.zeros((b, h, len(rows), d))
        for k0 in range(k_begin, k_end, bk):
            keys = torch.arange(k0, min(k0 + bk, sk))
            s = torch.einsum("bqhd,bkhd->bhqk", qt, k[:, keys]) * scale_log2
            live = torch.ones((len(rows), len(keys)), dtype=torch.bool)
            if causal:
                live &= keys[None, :] <= qp[:, None]
            if window:
                live &= keys[None, :] > qp[:, None] - window
            s = s.masked_fill(~live, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None]).masked_fill(~live, 0.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.bfloat16().float(), v[:, keys])
            m = m_new
        out[:, rows] = (acc / l.clamp_min(1e-30)[..., None]).transpose(1, 2)
    return out.bfloat16()


@pytest.mark.parametrize("case", [c for c in FLASH_CASES + RAGGED_CASES if c[-1] == "bfloat16"])
def test_bf16_kernel_numerics_fit_the_bar(case):
    """The bf16 kernel's roundings (P in bf16, base-2 softmax) against the
    Pallas kernel and its oracle, which keep P in f32, at the bf16 bar."""
    *_, causal, window, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(case, sum(case[:6])), dtype)
    got = _np(_wgmma_kernel_numerics(tq, tk, tv, causal=causal, window=window))
    want = _np(jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window))
    np.testing.assert_allclose(got, want, atol=TOL[dtype])
    sq, sk = case[1:3]
    if sq % min(128, sq) == 0 and sk % min(128, sk) == 0:
        pallas = _np(pallas_flash(jq, jk, jv, causal=causal, window=window, interpret=True))
        np.testing.assert_allclose(got, pallas, atol=TOL[dtype])


# Sq * Sk above 512**2: the reference model takes _flash_chunked, which
# rounds P to bf16 as the kernel does
@pytest.mark.parametrize("window", [None, 200])
def test_bf16_kernel_numerics_match_the_reference_models_chunked_attention(window):
    case = (1, 640, 640, 4, 2, 128, True, window, "bfloat16")
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(case, 640), "bfloat16")
    got = _np(_wgmma_kernel_numerics(tq, tk, tv, causal=True, window=window))
    want = _np(JL.attention(jq, jk, jv, window=window))
    np.testing.assert_allclose(got, want, atol=TOL["bfloat16"])


def _wgmma_bwd_numerics(q, k, v, do, *, causal, window):
    """The arithmetic of the bf16 backward kernels (``flash_bwd_dkdv_wgmma``
    and ``flash_bwd_dq_wgmma``), written out in PyTorch (CPU), on the
    forward kernel's output (:func:`_wgmma_kernel_numerics`): lse the
    natural log-sum-exp of the masked f32 scores, as the forward keeps it;
    delta = rowsum(dO o) in f32; over 64-query by 64-key tiles (the dK/dV
    kernel's query tiles, the dQ kernel's key tiles), S and dP in f32 from
    the bf16 inputs, P = exp2(S scale log2 e - lse log2 e) with masked
    entries 0, dS = P (dP - delta) from the f32 P, then P and dS rounded to
    bf16 before dV += P^T dO, dK += dS^T Q and dQ += dS K, accumulated in
    f32; dK and dQ times 1/sqrt(D), the GQA group summed, each rounded once
    to bf16."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    o = _wgmma_kernel_numerics(q, k, v, causal=causal, window=window)
    lse = ref.flash_attention_lse_ref(q, k, causal=causal, window=window)   # (B, H, Sq)
    lse2 = (lse * math.log2(math.e)).transpose(1, 2)                         # (B, Sq, H)
    delta = (do.float() * o.float()).sum(-1)                                 # (B, Sq, H)
    qf, dof = q.float(), do.float()
    kf = torch.repeat_interleave(k, g, dim=2).float()
    vf = torch.repeat_interleave(v, g, dim=2).float()
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    scale_log2 = torch.tensor(math.log2(math.e) / math.sqrt(d), dtype=torch.float32)
    mask = ref.attention_mask(sq, sk, causal, window, "cpu")
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, sq, 64):
        rq = slice(q0, min(q0 + 64, sq))
        for k0 in range(0, sk, 64):
            rk = slice(k0, min(k0 + 64, sk))
            s = torch.einsum("bqhd,bkhd->bhqk", qf[:, rq], kf[:, rk])
            dp = torch.einsum("bqhd,bkhd->bhqk", dof[:, rq], vf[:, rk])
            p = torch.exp2(s * scale_log2 - lse2[:, rq].transpose(1, 2)[..., None])
            p = p.masked_fill(~mask[rq, rk], 0.0)
            ds = p * (dp - delta[:, rq].transpose(1, 2)[..., None])
            p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
            dv[:, rk] += torch.einsum("bhqk,bqhd->bkhd", p16, dof[:, rq])
            dk[:, rk] += torch.einsum("bhqk,bqhd->bkhd", ds16, qf[:, rq])
            dq[:, rq] += torch.einsum("bhqk,bkhd->bqhd", ds16, kf[:, rk])
    dk = (dk * scale).reshape(b, sk, kh, g, d).sum(3)
    dv = dv.reshape(b, sk, kh, g, d).sum(3)
    return (dq * scale).bfloat16(), dk.bfloat16(), dv.bfloat16()


def _grads_close(got, want, bar, what):
    """Each gradient within ``bar`` of its max |want|."""
    for i, (a, w) in enumerate(zip(got, want)):
        a, w = _np(a).astype(np.float64), _np(w).astype(np.float64)
        top = np.abs(w).max()
        assert top > 0 and np.abs(a - w).max() <= bar * top, (what, "dq dk dv".split()[i],
                                                              np.abs(a - w).max() / top)


def _bwd_inputs(shape, seed):
    """q, k, v, dO drawn with numpy, as bf16 jax arrays and torch tensors."""
    b, sq, sk, h, kh, d = shape[:6]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s_).astype(np.float32)
              for s_ in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d), (b, sq, h, d))]
    return _both(arrays, "bfloat16")


# every shape of tests/test_torch_backward.py, in bf16: causal, a window, GQA
# groups of 1, 2 and 4, Sq < Sk ragged, Sq > Sk without a mask, D 64 and 128
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_bf16_backward_numerics_fit_the_bar(shape):
    """The bf16 backward kernels' roundings (P and dS in bf16, the base-2
    softmax off the forward's lse, the forward's bf16 output in delta)
    against the plain backward and ``jax.vjp`` of the reference's oracle,
    which keep P in f32, at the bf16 bar of chip_smoke's Z2b: 2e-2 of each
    gradient's max.  4.5-8.9 s each, 47.0 s in all, in the driver's 6-worker
    run of the whole suite (the reference's eager ``jax.vjp``)."""
    b, sq, sk, h, kh, d, causal, window = shape
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _bwd_inputs(shape, sq * sk + d)
    got = _wgmma_bwd_numerics(tq, tk, tv, tdo, causal=causal, window=window)
    assert [t.dtype for t in got] == [torch.bfloat16] * 3
    assert [t.shape for t in got] == [tq.shape, tk.shape, tv.shape]
    o = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    want = ref.flash_attention_bwd_ref(tq, tk, tv, o, tdo, causal=causal, window=window)
    _grads_close(got, want, 2e-2, "the plain backward")
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.flash_attention_ref(q_, k_, v_, causal=causal,
                                                                 window=window), jq, jk, jv)
    _grads_close(got, vjp(jdo), 2e-2, "jax.vjp of the reference's oracle")


# Sq * Sk above 512**2: the reference model's attention takes _flash_chunked,
# which rounds P to bf16 as the kernels do
@pytest.mark.parametrize("window", [None, 200])
def test_bf16_backward_numerics_match_the_reference_models_chunked_attention(window):
    """The bf16 backward's arithmetic against ``jax.vjp`` of
    ``repro.models.layers.attention`` at 2e-2 of each gradient's max.  18.9 s
    (window None) and 14.5 s (200) in the 6-worker run of the whole suite."""
    shape = (1, 640, 640, 4, 2, 128, True, window)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _bwd_inputs(shape, 641)
    got = _wgmma_bwd_numerics(tq, tk, tv, tdo, causal=True, window=window)
    _, vjp = jax.vjp(lambda q_, k_, v_: JL.attention(q_, k_, v_, window=window), jq, jk, jv)
    _grads_close(got, vjp(jdo), 2e-2, "jax.vjp of repro.models.layers.attention")


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_lse_ref_matches_jax_logsumexp_of_the_reference_scores(shape):
    """``ref.flash_attention_lse_ref`` (what the forward kernels keep for the
    backward) against ``jax.nn.logsumexp`` of the scores the reference's
    oracle forms (``repro/kernels/ref.py:11``: f32, scaled, masked to
    -1e30), within 1e-5 absolute (f32 sums in another order).  1.7-4.1 s each,
    16.8 s in all, in the 6-worker run of the whole suite."""
    b, sq, sk, h, kh, d, causal, window = shape
    rng = np.random.default_rng(sq + sk + d)
    q_np = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k_np = rng.standard_normal((b, sk, kh, d)).astype(np.float32)
    got = ref.flash_attention_lse_ref(torch.from_numpy(q_np), torch.from_numpy(k_np),
                                      causal=causal, window=window)
    kj = jnp.repeat(jnp.asarray(k_np), h // kh, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q_np), kj) / math.sqrt(d)
    qp = jnp.arange(sq)[:, None] + (sk - sq)
    kp = jnp.arange(sk)[None, :]
    mask = jnp.ones((sq, sk), bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    want = np.asarray(jax.nn.logsumexp(jnp.where(mask, s, -1e30), axis=-1))
    assert got.shape == (b, h, sq) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_cpu_lse_and_backward_wrappers_are_the_plain_versions():
    """On the CPU ``flash_attention_lse`` is the plain forward and the plain
    lse, and ``flash_attention_bwd`` the plain backward, with or without an
    lse; neither launches a kernel.  0.3 s in the 6-worker run of the whole
    suite."""
    case = (1, 40, 56, 4, 2, 64, True, 16, "bfloat16")
    _, (tq, tk, tv) = _both(_qkv(case, 5), "bfloat16")
    before = launch_counts()
    out, lse = flash_attention_lse(tq, tk, tv, causal=True, window=16)
    assert torch.equal(out, ref.flash_attention_ref(tq, tk, tv, causal=True, window=16))
    assert torch.equal(lse, ref.flash_attention_lse_ref(tq, tk, causal=True, window=16))
    do = torch.ones_like(tq)
    want = ref.flash_attention_bwd_ref(tq, tk, tv, out, do, causal=True, window=16)
    for given in (lse, None):
        got = flash_attention_bwd(tq, tk, tv, out, do, given, causal=True, window=16)
        assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert launch_counts() == before


def test_cpu_flash_launches_nothing_and_checks_inputs():
    before = launch_counts()
    q = torch.zeros(1, 8, 4, 32)
    kv = torch.zeros(1, 8, 2, 32)
    flash_attention(q, kv, kv)
    assert launch_counts() == before
    with pytest.raises(ValueError, match="do not split"):
        flash_attention(torch.zeros(1, 8, 3, 32), kv, kv)
    with pytest.raises(ValueError, match="Sq 9 > Sk 8"):
        flash_attention(torch.zeros(1, 9, 4, 32), kv, kv)
    with pytest.raises(TypeError, match="share one of"):
        flash_attention(q.double(), kv, kv)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, kv.transpose(1, 2).contiguous().transpose(1, 2), kv)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, kv, kv, window=0)


def test_ops_match_the_reference_ops():
    """The four ops under the reference's names give the reference ops'
    results (the reference runs its plain versions on the CPU)."""
    rng = np.random.default_rng(11)
    case = (1, 64, 64, 4, 2, 32, True, None, "float32")
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(case, 2), "float32")
    np.testing.assert_allclose(ops.attention_op(tq, tk, tv, window=16).numpy(),
                               np.asarray(jops.attention_op(jq, jk, jv, window=16)), atol=2e-5)
    f = np.abs(rng.standard_normal((9, 24))).astype(np.float32)
    w = (rng.standard_normal((24, 8)) / 5).astype(np.float32)
    b = (0.1 * rng.standard_normal(8)).astype(np.float32)
    q, s = ops.compress_op(*(torch.from_numpy(a) for a in (f, w, b)))
    jq8, js = jops.compress_op(*(jnp.asarray(a) for a in (f, w, b)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq8))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=2e-6)
    np.testing.assert_array_equal(ops.decompress_op(q, s).numpy(),
                                  np.asarray(jops.decompress_op(jnp.asarray(q.numpy()),
                                                                jnp.asarray(s.numpy()))))
    r, k, v = (rng.standard_normal((1, 12, 2, 16)).astype(np.float32) for _ in range(3))
    dec = np.exp(-np.exp(rng.standard_normal((1, 12, 2, 16)) - 1)).astype(np.float32)
    u = (0.3 * rng.standard_normal((2, 16))).astype(np.float32)
    out, state = ops.wkv_op(*(torch.from_numpy(a) for a in (r, k, v, dec, u)))
    jout, jstate = jops.wkv_op(*(jnp.asarray(a) for a in (r, k, v, dec, u)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), atol=1e-5)


# ----------------------------------------------------------------- layers ----
def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                               np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
                               rtol=1e-5, atol=1e-6)
    pos = np.arange(9) + 1000
    tc, ts = TL.rope_tables(torch.from_numpy(pos), 32, 500000.0)
    jc, js = JL.rope_tables(jnp.asarray(pos), 32, 500000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    got = TL.apply_rope(torch.from_numpy(x), tc, ts).numpy()
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jc, js))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(TL.repeat_kv(torch.from_numpy(x), 3).numpy(),
                                  np.asarray(JL.repeat_kv(jnp.asarray(x), 3)))


# S = 16 takes the reference's plain branch, S = 640 (Sq*Sk > 512**2) its chunked one
@pytest.mark.parametrize("s,window", [(16, None), (16, 5), (640, None), (640, 200)])
def test_attention_matches_both_reference_branches(s, window):
    case = (1, s, s, 4, 2, 16, True, window, "float32")
    q, k, v = _qkv(case, s)
    got = TL.attention(*(torch.from_numpy(a) for a in (q, k, v)), window=window).numpy()
    want = np.asarray(JL.attention(*(jnp.asarray(a) for a in (q, k, v)), window=window))
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("window", [None, 6])
def test_decode_attention_matches_reference_on_a_ring_buffer(window):
    rng = np.random.default_rng(3)
    b, sc, h, kh, d = 2, 10, 4, 2, 16
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    kc = rng.standard_normal((b, sc, kh, d)).astype(np.float32)
    vc = rng.standard_normal((b, sc, kh, d)).astype(np.float32)
    # a ring buffer part-way round, with empty slots (-1) in the second row
    kv_pos = np.array([[10, 11, 12, 3, 4, 5, 6, 7, 8, 9],
                       [0, 1, 2, 3, 4, 5, 6, -1, -1, -1]], np.int32)
    q_pos = np.array([12, 6], np.int32)
    got = TL.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc, kv_pos, q_pos)),
                              window=window).numpy()
    want = np.asarray(JL.decode_attention(*(jnp.asarray(a) for a in (q, kc, vc, kv_pos, q_pos)),
                                          window=window))
    np.testing.assert_allclose(got, want, atol=2e-6)
