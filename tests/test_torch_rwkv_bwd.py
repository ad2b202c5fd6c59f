"""The schedule of the rwkv6_scan backward kernel (``csrc/rwkv6_scan_bwd.cu``)
written out in PyTorch on the CPU, against the plain backward
(``ref.rwkv6_scan_bwd_ref``), autograd through the plain scan and ``jax.vjp``
of the JAX package's oracle (``repro/kernels/ref.py:62``) and of the model's
own chunked scan (``repro.models.rwkv.wkv_scan``, ``repro/models/rwkv.py:89``),
which is what the reference trains through.

The schedule: chunks of T steps, the last padded with w = 1 and zeros;
phase A each chunk's state and gradient from zero, as products of k and r
scaled by their decay products within the chunk with v and dout, and its
rows' decay product; phase B the scan over chunks from the start state and the final
state's gradient; phase C each chunk from its boundary values, its states
kept at the start of each L-step sub-chunk and recomputed a sub-chunk at a
time, each group of CW columns' partials of dr, dk, dw and du added in the
cluster's rank order.  T, L and CW are read from the CUDA source, as built.

Bar, fixed before measuring: each gradient within 1e-5 of its max |g| (f32
sums in other orders).  Inputs are drawn with numpy from a seed.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as JR  # noqa: E402
from repro.models.rwkv import wkv_scan  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

_CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
       / "rwkv6_scan_bwd.cu").read_text()


def _size(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _CU).group(1))


T, L, CW = _size("T"), _size("L"), _size("CW")
BAR = 1e-5
# (B, S, H): one step, either side of a chunk's edge, two chunks and a tail
SHAPES = [(2, 1, 3), (2, T - 1, 2), (2, T, 3), (2, T + 1, 2), (2, 2 * T + 5, 2)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module (six test processes
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def schedule_bwd(r, k, v, w, u, state, dout, dstate, t=T, sub=L, cw=CW) -> tuple:
    """(dr, dk, dv, dw, du, dstate0) by the kernel's three phases."""
    b, s, h, d = r.shape
    nc, ncg = -(-s // t), d // cw

    def chunks(x, fill):  # (B, S, H, D) -> (B, H, nc, T, D), padded with ``fill``
        pad = torch.full((b, nc * t - s, h, d), fill, dtype=x.dtype)
        return torch.cat([x, pad], 1).reshape(b, nc, t, h, d).permute(0, 3, 1, 2, 4)
    rc, kc, vc, gc = (chunks(x, 0.0) for x in (r, k, v, dout))
    wc = chunks(w, 1.0)

    # phase A: each chunk from zero, S_loc = sum_t k~_t v_t^T and G_loc = sum_t
    # r~_t dout_t^T with k~_t = k_t prod_{t' > t} w_t' and r~_t = r_t prod_{t' < t}
    # w_t', each product walked step by step; P the chunk's decay
    kt, rt = torch.empty_like(kc), torch.empty_like(rc)
    p = torch.ones((b, h, nc, d))
    for st in range(t - 1, -1, -1):
        kt[..., st, :] = kc[..., st, :] * p
        p = p * wc[..., st, :]
    p = torch.ones((b, h, nc, d))
    for st in range(t):
        rt[..., st, :] = rc[..., st, :] * p
        p = p * wc[..., st, :]                                # (B, H, nc, D)
    s_loc = torch.einsum("bhctd,bhcte->bhcde", kt, vc)
    g_loc = torch.einsum("bhctd,bhcte->bhcde", rt, gc)

    # phase B: the chunks' start states and end gradients
    s_start, g_end = torch.empty_like(s_loc), torch.empty_like(g_loc)
    acc = state
    for c in range(nc):
        s_start[:, :, c] = acc
        acc = p[:, :, c, :, None] * acc + s_loc[:, :, c]
    acc = dstate
    for c in range(nc - 1, -1, -1):
        g_end[:, :, c] = acc
        acc = p[:, :, c, :, None] * acc + g_loc[:, :, c]
    dstate0 = acc

    # phase C: every chunk at once, the columns split into ncg groups of cw
    def groups(x):  # (..., D) columns -> (..., ncg, cw)
        return x.reshape(*x.shape[:-1], ncg, cw)
    S = groups(s_start)                                       # (B, H, nc, D, ncg, cw)
    G = groups(g_end)
    vq, gq = groups(vc), groups(gc)                           # (B, H, nc, T, ncg, cw)
    starts = []
    for sq in range(t // sub):
        starts.append(S)
        for st in range(sq * sub, (sq + 1) * sub):
            S = (wc[..., st, :, None, None] * S
                 + kc[..., st, :, None, None] * vq[..., st, None, :, :])
    a_t = (rc * u[None, :, None, None, :] * kc).sum(-1)      # (B, H, nc, T)
    part = torch.zeros((3, b, h, nc, t, ncg, d))             # dr, dk, dw a group
    du_part = torch.zeros((b, h, nc, ncg, d))
    dv = torch.zeros((b, h, nc, t, ncg, cw))
    uu = u[None, :, None, :, None]                            # (1, H, 1, D, 1)
    for sq in range(t // sub - 1, -1, -1):
        S, hist = starts[sq], []
        for st in range(sq * sub, (sq + 1) * sub):
            hist.append(S)
            S = (wc[..., st, :, None, None] * S
                 + kc[..., st, :, None, None] * vq[..., st, None, :, :])
        for st in range((sq + 1) * sub - 1, sq * sub - 1, -1):
            rr, kk, ww = (x[..., st, :, None] for x in (rc, kc, wc))    # (B, H, nc, D, 1)
            vv, gg = vq[..., st, None, :, :], gq[..., st, None, :, :]    # (B, H, nc, 1, ncg, cw)
            sp = hist[st - sq * sub]
            vd = (vv * gg).sum(-1)                                      # (B, H, nc, 1, ncg)
            part[0, ..., st, :, :] = ((sp * gg).sum(-1) + uu * kk * vd).transpose(-1, -2)
            part[1, ..., st, :, :] = ((G * vv).sum(-1) + rr * uu * vd).transpose(-1, -2)
            part[2, ..., st, :, :] = (G * sp).sum(-1).transpose(-1, -2)
            du_part += (rr * kk * vd).transpose(-1, -2)
            dv[..., st, :, :] = ((G * kk[..., None]).sum(-3)
                                 + a_t[..., st, None, None] * gq[..., st, :, :])
            G = ww[..., None] * G + rr[..., None] * gg
    # the cluster: the column groups' partials added in rank order
    sums = part[:, :, :, :, :, 0]
    du_sum = du_part[..., 0, :]
    for q in range(1, ncg):
        sums = sums + part[:, :, :, :, :, q]
        du_sum = du_sum + du_part[..., q, :]

    def steps(x):  # (B, H, nc, T, ...) -> (B, S, H, ...)
        x = x.permute(0, 2, 3, 1, *range(4, x.dim()))
        return x.reshape(b, nc * t, h, *x.shape[4:])[:, :s]
    dr, dk, dw = (steps(x) for x in sums)
    du = torch.zeros_like(u)
    for bb in range(b):
        for c in range(nc):
            du = du + du_sum[bb, :, c]
    return dr, dk, steps(dv).reshape(b, s, h, d), dw, du, dstate0


# log(-log w) = N(0, 1) + shift, and u's scale: Z5b's decays (about 0.55, down
# to 1e-9), those whose products over a chunk underflow f32 to 0, and the
# served model's (about 0.98)
DECAYS = {"z5b": (-1.0, 1.0, 0.3), "underflow": (1.0, 1.0, 0.3), "served": (-4.0, 0.5, 0.1)}


def _draw(shape, decays):
    b, s, h = shape
    shift, spread, u_scale = DECAYS[decays]
    rng = np.random.default_rng(s * 10 + h + len(decays))
    r, k, v = (0.5 * rng.standard_normal((b, s, h, 64)) for _ in range(3))
    w = np.exp(-np.exp(shift + spread * rng.standard_normal((b, s, h, 64))))
    u = u_scale * rng.standard_normal((h, 64))
    st = 0.2 * rng.standard_normal((b, h, 64, 64))
    dout, dst = rng.standard_normal((b, s, h, 64)), rng.standard_normal((b, h, 64, 64))
    return [a.astype(np.float32) for a in (r, k, v, w, u, st, dout, dst)]


def _jit_vjp(fn):
    """``jax.vjp`` of ``fn`` under ``jax.jit``: compiled once a shape, so the
    decay regimes of one shape share it."""
    return jax.jit(lambda ins, cot: jax.vjp(fn, *ins)[1](cot))


_VJPS = {"the oracle": _jit_vjp(JR.rwkv6_scan_ref), "wkv_scan": _jit_vjp(wkv_scan)}


def _close(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        top = np.abs(b).max()
        assert top > 0 and np.abs(a - b).max() <= BAR * top, (what, i)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("decays", list(DECAYS))
def test_schedule_matches_plain_autograd_and_jax(shape, decays):
    """From a nonzero start state with a nonzero final-state gradient, at
    each of ``DECAYS``."""
    arrays = _draw(shape, decays)
    tins = [torch.from_numpy(a) for a in arrays]
    got = schedule_bwd(*tins)
    assert [g.shape for g in got] == [t.shape for t in tins[:6]]
    if decays == "underflow" and shape[1] >= T:
        assert float(tins[3][:, :T].prod(1).min()) == 0.0    # a chunk's decay underflows
    _close(got, ref.rwkv6_scan_bwd_ref(*tins), "the plain backward")
    live = [t.clone().requires_grad_() for t in tins[:6]]
    plain = torch.autograd.grad(ref.rwkv6_scan_ref(*live), live, tuple(tins[6:]))
    _close(got, plain, "autograd through the plain scan")
    jins = [jnp.asarray(a) for a in arrays[:6]]
    cot = (jnp.asarray(arrays[6]), jnp.asarray(arrays[7]))
    for name, vjp in _VJPS.items():
        _close(got, vjp(jins, cot), f"jax.vjp of {name}")


def test_sizes_tile_the_head():
    """The sizes read from the source make whole sub-chunks and at most 8
    column groups (a portable cluster)."""
    assert T % L == 0 and 64 % CW == 0 and 64 // CW <= 8
