"""The f32 CUDA flash kernels' block and tile schedule, written out in
PyTorch (CPU, f32) at their real tile sizes, against the JAX package.

``flash_fwd_f32`` (``csrc/flash_attention.cu``) and ``flash_bwd_dq``,
``flash_bwd_dkdv`` (``csrc/flash_attention_bwd.cu``) cut the work as
``kernels.flash_attention.f32_tiles`` says: the forward and dQ a block of 64
queries over the D-key tiles its rows can see, the online softmax tile by
tile (natural exp, running max and sum); dK/dV a block of 64 keys over the
D-query tiles of each head of its GQA group that can see one of its keys.
Here that schedule is held to the Pallas kernel in interpret mode (whole
tiles only, as it asserts), the reference's oracle
(``repro/kernels/ref.py:11``) and ``jax.vjp`` of it, and the port's plain
versions, at 1e-5 (of each gradient's max): f32 sums in another order.  The
visited tiles must cover every live query-key pair, and the Python tile
table must be the one the CUDA sources fix.  About 60 s of test time in the
driver's 6-worker run, 38 s alone (the reference's eager ``jax.vjp`` and the
Pallas kernel in interpret mode).
"""
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

ROWS = FA.F32_ROWS
BAR = 1e-5
CSRC = Path(FA.__file__).resolve().parents[1] / "csrc"

# b, sq, sk, h, kh, d, causal, window: whole tiles (GQA 3; a window across
# the 64-row block and the 128-key tile; unmasked Sq > Sk), Sq and Sk at a
# tile size and one off either way, a window of 1, a window across a tile,
# unmasked ragged Sq > Sk; head dims 64 and 128, GQA groups 1 and 3
CASES = [
    (1, 128, 128, 3, 1, 64, True, None),
    (1, 64, 128, 2, 2, 128, True, 100),
    (1, 256, 128, 2, 2, 64, False, None),
    (1, 63, 65, 3, 1, 64, True, None),
    (1, 65, 129, 2, 2, 128, True, None),
    (1, 128, 128, 6, 2, 128, True, 1),
    (1, 129, 129, 3, 1, 64, True, 65),
    (2, 129, 127, 3, 1, 128, False, None),
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module (six test processes
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key_range(q0, sq, sk, causal, window, bk):
    """Keys the query rows [q0, q0 + ROWS) can see, [begin, end), begin on
    a bk-key tile (the kernels' key_range)."""
    shift = sk - sq
    q_lo, q_hi = q0 + shift, min(q0 + ROWS, sq) - 1 + shift
    end = min(sk, q_hi + 1) if causal else sk
    begin = max(0, q_lo - window + 1) // bk * bk if window else 0
    return begin, end


def _query_range(k0, sq, sk, causal, window):
    """Query rows that can see a key of [k0, k0 + ROWS), [lo, hi] (the
    kernels' query_range)."""
    shift, k_last = sk - sq, min(k0 + ROWS, sk) - 1
    lo = max(0, k0 - shift) if causal else 0
    hi = min(sq - 1, k_last + window - 1 - shift) if window else sq - 1
    return lo, hi


def _query_block_tiles(sq, sk, causal, window, d):
    """(query rows, keys) of each (64-query block, D-key tile) the forward
    and the dQ kernel visit."""
    for q0 in range(0, sq, ROWS):
        begin, end = _key_range(q0, sq, sk, causal, window, d)
        for k0 in range(begin, end, d):
            yield slice(q0, min(q0 + ROWS, sq)), slice(k0, min(k0 + d, sk))


def _key_block_tiles(sq, sk, causal, window, d):
    """(query rows, keys) of each (64-key block, D-query tile) the dK/dV
    kernel visits (for each query head of the block's kv head)."""
    for k0 in range(0, sk, ROWS):
        lo, hi = _query_range(k0, sq, sk, causal, window)
        for t in range(lo // d, hi // d + 1 if hi >= lo else lo // d):
            yield slice(t * d, min(t * d + d, sq)), slice(k0, min(k0 + ROWS, sk))


def _simt_f32_kernel_numerics(q, k, v, *, causal, window):
    """The f32 forward kernel's arithmetic, written out in PyTorch: for
    each 64-query block, over its key tiles in order, S = q K^T in f32
    times 1/sqrt(D), masked entries -1e30 and exact zeros after the
    exponential, the online softmax's running max and sum (natural exp),
    O rescaled and P V added; out = O / max(sum, 1e-30), lse = max +
    log(sum).  Returns (out, lse)."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    kf = torch.repeat_interleave(k, h // kh, dim=2).float()
    vf = torch.repeat_interleave(v, h // kh, dim=2).float()
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    mask = ref.attention_mask(sq, sk, causal, window, "cpu")
    out = torch.zeros((b, sq, h, d))
    lse = torch.zeros((b, h, sq))
    for q0 in range(0, sq, ROWS):
        rows = slice(q0, min(q0 + ROWS, sq))
        n = rows.stop - rows.start
        m = torch.full((b, h, n), -1e30)
        l = torch.zeros((b, h, n))
        acc = torch.zeros((b, h, n, d))
        begin, end = _key_range(q0, sq, sk, causal, window, d)
        for k0 in range(begin, end, d):
            keys = slice(k0, min(k0 + d, sk))
            live = mask[rows, keys]
            s = torch.einsum("bqhd,bkhd->bhqk", q[:, rows].float(), kf[:, keys]) * scale
            s = s.masked_fill(~live, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None]).masked_fill(~live, 0.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vf[:, keys])
            m = m_new
        out[:, rows] = (acc / l.clamp_min(1e-30)[..., None]).transpose(1, 2)
        lse[:, :, rows] = m + torch.log(l)
    return out, lse


def _simt_f32_bwd_numerics(q, k, v, do, *, causal, window):
    """The f32 backward kernels' arithmetic on the forward kernel's output
    and lse (:func:`_simt_f32_kernel_numerics`): delta = rowsum(dO o);
    dK/dV a 64-key block at a time over the D-query tiles of each query
    head of its kv head's group, P^T = exp(S^T / sqrt(D) - lse) with masked
    entries zero, dS^T = P^T (dP^T - delta), dV += P^T dO, dK += dS^T Q;
    dQ a 64-query block at a time over its D-key tiles, dQ += dS K; dK and
    dQ times 1/sqrt(D)."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    o, lse = _simt_f32_kernel_numerics(q, k, v, causal=causal, window=window)
    delta = (do.float() * o).sum(-1).transpose(1, 2)                   # (B, H, Sq)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    mask = ref.attention_mask(sq, sk, causal, window, "cpu")
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    for c in range(kh):
        for rq, rk in _key_block_tiles(sq, sk, causal, window, d):
            for h_ in range(c * g, c * g + g):
                st = torch.einsum("bkd,bqd->bkq", kf[:, rk, c], qf[:, rq, h_]) * scale
                pt = torch.exp(st - lse[:, h_, rq][:, None]).masked_fill(~mask[rq, rk].T, 0.0)
                dpt = torch.einsum("bkd,bqd->bkq", vf[:, rk, c], dof[:, rq, h_])
                dst = pt * (dpt - delta[:, h_, rq][:, None])
                dv[:, rk, c] += torch.einsum("bkq,bqd->bkd", pt, dof[:, rq, h_])
                dk[:, rk, c] += torch.einsum("bkq,bqd->bkd", dst, qf[:, rq, h_])
    for h_ in range(h):
        c = h_ // g
        for rq, rk in _query_block_tiles(sq, sk, causal, window, d):
            s = torch.einsum("bqd,bkd->bqk", qf[:, rq, h_], kf[:, rk, c]) * scale
            p = torch.exp(s - lse[:, h_, rq][..., None]).masked_fill(~mask[rq, rk], 0.0)
            dp = torch.einsum("bqd,bkd->bqk", dof[:, rq, h_], vf[:, rk, c])
            ds = p * (dp - delta[:, h_, rq][..., None])
            dq[:, rq, h_] += torch.einsum("bqk,bkd->bqd", ds, kf[:, rk, c])
    return dq * scale, dk * scale, dv


def _inputs(case, seed):
    b, sq, sk, h, kh, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d), (b, sq, h, d))]


def _grads_close(got, want, scales, what):
    for name, a, w, top in zip(("dq", "dk", "dv"), got, want, scales):
        gap = np.abs(np.asarray(a, np.float64) - np.asarray(w, np.float64)).max()
        assert top > 0 and gap <= BAR * top, (what, name, gap / top)


@pytest.mark.parametrize("case", CASES)
def test_f32_forward_schedule_matches_pallas_oracle_and_plain(case):
    """The forward schedule's output against the reference's oracle and,
    on whole tiles, the Pallas kernel in interpret mode; its lse against
    ``ref.flash_attention_lse_ref``; 1e-5 absolute."""
    b, sq, sk, h, kh, d, causal, window = case
    qn, kn, vn, _ = _inputs(case, sq * sk + d)
    tq, tk, tv = (torch.from_numpy(a) for a in (qn, kn, vn))
    got, lse = _simt_f32_kernel_numerics(tq, tk, tv, causal=causal, window=window)
    jq, jk, jv = (jnp.asarray(a) for a in (qn, kn, vn))
    want = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BAR)
    np.testing.assert_allclose(lse.numpy(), ref.flash_attention_lse_ref(
        tq, tk, causal=causal, window=window).numpy(), rtol=0, atol=BAR)
    if sq % min(128, sq) == 0 and sk % min(128, sk) == 0:
        pallas = np.asarray(pallas_flash(jq, jk, jv, causal=causal, window=window,
                                         interpret=True))
        np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=BAR)


@pytest.mark.parametrize("case", CASES)
def test_f32_backward_schedule_matches_vjp_and_plain(case):
    """The backward schedule's dq, dk, dv against ``jax.vjp`` of the
    reference's oracle and ``ref.flash_attention_bwd_ref`` on the same
    output, each within 1e-5 of its max (with a window of 1 each row sees
    one key: dq and dk are 0 in exact arithmetic, held at dv's scale)."""
    b, sq, sk, h, kh, d, causal, window = case
    qn, kn, vn, don = _inputs(case, sq * sk + d + 1)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (qn, kn, vn, don))
    got = _simt_f32_bwd_numerics(tq, tk, tv, tdo, causal=causal, window=window)
    assert [t.shape for t in got] == [tq.shape, tk.shape, tv.shape]
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.flash_attention_ref(q_, k_, v_, causal=causal,
                                                                 window=window),
                     *(jnp.asarray(a) for a in (qn, kn, vn)))
    want = [np.asarray(g_) for g_ in vjp(jnp.asarray(don))]
    scales = [float(np.abs(w).max()) for w in want]
    if window == 1:
        scales = [scales[2]] * 3
    _grads_close(got, want, scales, "jax.vjp of the reference's oracle")
    o = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    plain = ref.flash_attention_bwd_ref(tq, tk, tv, o, tdo, causal=causal, window=window)
    _grads_close(got, plain, scales, "the plain backward")


def _live_pairs(sq, sk, causal, window):
    """Live query-key pairs, as chip_smoke.live_pairs counts them."""
    p = np.arange(sq) + (sk - sq)
    hi = p if causal else np.full(sq, sk - 1)
    lo = np.maximum(p - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (2000, 2000, True, None), (777, 777, True, None), (500, 2000, True, None),
    (2000, 2000, True, 512), (1500, 1500, False, None), (2000, 1500, False, None),
    (448, 1500, False, None), (129, 129, True, 1), (129, 127, False, None), (65, 129, True, 65)])
def test_f32_tiles_cover_every_live_pair(sq, sk, causal, window, d):
    """The (query block, key tile) pairs the forward and dQ visit, and the
    (key block, query tile) pairs dK/dV visit, hold every live pair: the
    live pairs inside them are all ``live_pairs`` counts."""
    mask = ref.attention_mask(sq, sk, causal, window, "cpu").numpy()
    assert int(mask.sum()) == _live_pairs(sq, sk, causal, window)
    for tiles in (_query_block_tiles, _key_block_tiles):
        seen = np.zeros_like(mask)
        for rq, rk in tiles(sq, sk, causal, window, d):
            seen[rq, rk] = True
        assert int((mask & seen).sum()) == _live_pairs(sq, sk, causal, window), tiles.__name__


def test_f32_tile_table_matches_the_cuda_sources():
    """``F32_ROWS`` and ``f32_tiles`` are what ``csrc/flash_f32.cuh`` and
    the kernels' plans fix: 64 rows a product (8 groups of 8), 4 columns a
    lane (so 2 D threads a product); the forward and dQ a block of ROWS
    queries over D-key tiles, dK/dV a block of ROWS keys over D-query
    tiles, two products' threads."""
    header = (CSRC / "flash_f32.cuh").read_text()
    consts = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", header)}
    tm, tn = (int(v) for v in re.search(r"constexpr int TM = (\d+), TN = (\d+);", header).groups())
    assert consts["ROWS"] == FA.F32_ROWS
    assert (tm, tn) == (8, 4)
    assert "static constexpr int NL = D / TN;" in header
    assert "static constexpr int NT = NL * NG;" in header
    fwd = (CSRC / "flash_attention.cu").read_text()
    bwd = (CSRC / "flash_attention_bwd.cu").read_text()
    assert "static constexpr int BQ = ROWS, BK = D;" in fwd
    assert "static constexpr int BQ = ROWS, BK = D;" in bwd
    assert "static constexpr int BK = ROWS, BQ = D, NT = 2 * L::NT;" in bwd
    for d in FA.HEAD_DIMS:
        nt = d // tn * (consts["ROWS"] // tm)
        tiles = FA.f32_tiles(d)
        assert tiles["fwd"] == {"threads": nt, "queries": consts["ROWS"], "keys": d}
        assert tiles["dq"] == {"threads": nt, "queries": consts["ROWS"], "keys": d}
        assert tiles["dkdv"] == {"threads": 2 * nt, "keys": consts["ROWS"], "queries": d}
