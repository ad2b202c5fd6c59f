"""The mamba_scan backward: the plain reverse loop (``ref.mamba_scan_bwd_ref``)
against autograd through the plain scan, ``jax.vjp`` of the JAX package's
oracle (``repro/kernels/ref.py:79``) and the port's mixer against ``jax.vjp``
of ``repro.models.mamba.mamba_seq``, which is what the reference trains
through; the schedule of the CUDA kernel (``csrc/mamba_scan_bwd.cu``) written
out in PyTorch on the CPU against the plain backward; the wrapper on CPU
tensors.

The schedule: chunks of T steps and CPB channels, padded with zeros (dt 0
gives a_t = 1, through which the state and its gradient pass unchanged);
phase A each chunk's state and gradient from zero, the latter through a
running product of a_t, and its decay; phase B the scan over chunks from the
start state and the final state's gradient; phase C each chunk from its
boundary values, its states kept at the start of each L-step sub-chunk and
recomputed a sub-chunk at a time, each thread's E entries summed in the
thread, dx and ddt over the channel's lanes and dB and dC over a warp's 8
channels in the reduce-scatters' order, then over the block's warps and the
channel groups in order, and dA over the chunks in order.  T, L, CPB and E
are read from the CUDA source, as built.

Bar, fixed before measuring: each gradient within 1e-5 of its max |g| (f32
sums in other orders).  Inputs are drawn with numpy from a seed.  19.9 s of
test time in a 6-worker run (``-n 6 --dist loadfile``).
"""
import dataclasses
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro.models.common import reduced as jreduced  # noqa: E402
from repro_torch.configs import SERVED, get_config  # noqa: E402
from repro_torch.kernels import launch_counts, ref  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.models import mamba as TM  # noqa: E402
from repro_torch.models.common import reduced  # noqa: E402

_CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
       / "mamba_scan_bwd.cu").read_text()


def _size(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _CU).group(1))


T, L, CPB, E = _size("T"), _size("L"), _size("CPB"), _size("E")
DS = 16
BAR = 1e-5
LOG2E, LN2 = np.float32(1.4426950408889634), np.float32(0.6931471805599453)
# (B, S, di): one step, either side of a chunk's edge, two chunks and a
# tail; di a block's channels, and not a multiple of them (one group and a
# part, less than one)
SHAPES = [(2, 1, 70), (1, T - 1, CPB), (2, T, 24), (1, T + 1, 70), (2, 2 * T + 5, 40)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module (six test processes
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(b, s, di, served_a=False, seed=0, state=True):
    """Z7b's inputs: A = -exp(0.3 N(0, 1)) and dt = 0.1 softplus(N(0, 1)),
    or the served model's A, -(1 .. 16) in every channel, with dt =
    softplus(N(0, 1)), where |dt A| reaches 10-20; a nonzero start state and
    nonzero gradients of y and of the final state."""
    rng = np.random.default_rng(seed + 7 * s + di)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)))) * (1.0 if served_a else 0.1)
    bm, cm = (0.5 * rng.standard_normal((b, s, DS)) for _ in range(2))
    x = rng.standard_normal((b, s, di))
    if served_a:
        a = -np.broadcast_to(np.arange(1, DS + 1, dtype=np.float64), (di, DS)).copy()
    else:
        a = -np.exp(0.3 * rng.standard_normal((di, DS)))
    st = 0.3 * rng.standard_normal((b, di, DS)) * state
    dy, dst = rng.standard_normal((b, s, di)), rng.standard_normal((b, di, DS))
    return [v.astype(np.float32) for v in (dt, bm, cm, x, a, st, dy, dst)]


def _close(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (what, i)
        top = np.abs(b).max()
        assert top > 0 and np.abs(a - b).max() <= BAR * top, (what, i, np.abs(a - b).max() / top)


def _lanes_add(v):
    """(..., 4) over a channel's 4 lanes in the reduce-scatter's order: the
    lanes 2 apart, then the neighbours."""
    return (v[..., 0] + v[..., 2]) + (v[..., 1] + v[..., 3])


def _in_thread(v):
    """(..., E) summed over a thread's entries in ascending order."""
    acc = v[..., 0]
    for i in range(1, v.shape[-1]):
        acc = acc + v[..., i]
    return acc


def schedule_bwd(dt, b, c, x, a, state, dy, dstate, t=T, sub=L, cpb=CPB, e=E):
    """(ddt, db, dc, dx, da, dstate0) by the kernel's phases."""
    bsz, s, di = dt.shape
    nc, ng = -(-s // t), -(-di // cpb)
    dp = ng * cpb

    def chan(v):   # (B, S, di) -> (B, nc, T, dp), zero-padded
        out = torch.zeros((bsz, nc * t, dp))
        out[:, :s, :di] = v
        return out.reshape(bsz, nc, t, dp)

    def steps(v):  # (B, S, DS) -> (B, nc, T, DS)
        out = torch.zeros((bsz, nc * t, DS))
        out[:, :s] = v
        return out.reshape(bsz, nc, t, DS)

    def ent(v):    # (..., di, DS) -> (..., dp, DS)
        out = torch.zeros((*v.shape[:-2], dp, DS))
        out[..., :di, :] = v
        return out
    dtc, xc, dyc = chan(dt), chan(x), chan(dy)
    bc, cc = steps(b), steps(c)
    ap, h0, gS = ent(a), ent(state), ent(dstate)
    a2 = ap * LOG2E
    at = torch.exp(dtc[..., None] * ap)                        # (B, nc, T, dp, DS)
    u = (dtc * xc)[..., None] * bc[..., None, :]
    cdy = cc[..., None, :] * dyc[..., None]                     # C_t dy_t

    # phase A: each chunk from zero; p the running product of a_t
    s_loc = torch.zeros((bsz, nc, dp, DS))
    g_loc = torch.zeros_like(s_loc)
    p = torch.ones_like(s_loc)
    for st in range(t):
        s_loc = at[:, :, st] * s_loc + u[:, :, st]
        p = p * at[:, :, st]
        g_loc = p * cdy[:, :, st] + g_loc
    # phase B: each chunk's start state and end gradient
    h_start, g_end = torch.empty_like(s_loc), torch.empty_like(g_loc)
    acc = h0
    for ch in range(nc):
        h_start[:, ch] = acc
        acc = p[:, ch] * acc + s_loc[:, ch]
    acc = gS
    for ch in range(nc - 1, -1, -1):
        g_end[:, ch] = acc
        acc = p[:, ch] * acc + g_loc[:, ch]
    dstate0 = acc[:, :di]

    # phase C: every chunk at once; a sub-chunk's starts by a forward walk
    starts, h = [], h_start
    for sq in range(t // sub):
        starts.append(h)
        for st in range(sq * sub, (sq + 1) * sub):
            h = at[:, :, st] * h + u[:, :, st]
    g_hat = g_end
    da_part = torch.zeros_like(h_start)
    dx, ddt = torch.empty_like(dtc), torch.empty_like(dtc)
    part = torch.empty((bsz, nc, t, ng, 2 * DS))                # each block's dB, dC
    lanes = DS // e
    for sq in range(t // sub - 1, -1, -1):
        hist, h = [], starts[sq]
        for st in range(sq * sub, (sq + 1) * sub):
            hist.append(h)
            h = at[:, :, st] * h + u[:, :, st]
        for st in range((sq + 1) * sub - 1, sq * sub - 1, -1):
            hp = hist[st - sq * sub]
            dtv, xv, dyv = dtc[:, :, st, :, None], xc[:, :, st, :, None], dyc[:, :, st, :, None]
            g = cdy[:, :, st] + g_hat
            gq = g * (at[:, :, st] * hp)
            split = (bsz, nc, dp, lanes, e)
            sb = _in_thread((g * bc[:, :, st, None, :]).reshape(split))     # (B, nc, dp, lanes)
            sa = _in_thread((gq * a2).reshape(split))
            da_part = gq * dtv + da_part
            dx[:, :, st] = _lanes_add(dtv * sb)
            ddt[:, :, st] = _lanes_add(xv * sb + sa * LN2)
            for k, v in enumerate((g * (dtv * xv), h * dyv)):
                # over a warp's 8 channels (lane bits 16, 8, 4: channel bits
                # 2, 1, 0), then the block's warps in order
                w = v.reshape(bsz, nc, ng, cpb // 8, 2, 2, 2, DS)
                w = (w[..., 0, :, :, :] + w[..., 1, :, :, :])
                w = (w[..., 0, :, :] + w[..., 1, :, :])
                w = (w[..., 0, :] + w[..., 1, :])                  # (B, nc, ng, warps, DS)
                blk = w[..., 0, :]
                for wp in range(1, w.shape[-2]):
                    blk = blk + w[..., wp, :]
                part[:, :, st, :, k * DS:(k + 1) * DS] = blk
            g_hat = at[:, :, st] * g
            h = hp

    # the sums: dB and dC over the groups in order, dA over (b, chunk) in order
    acc = part[..., 0, :]
    for gr in range(1, ng):
        acc = acc + part[..., gr, :]
    acc = acc.reshape(bsz, nc * t, 2 * DS)[:, :s]
    da = da_part[0, 0]
    for bb in range(bsz):
        for ch in range(nc):
            if bb or ch:
                da = da + da_part[bb, ch]

    def back(v):   # (B, nc, T, dp) -> (B, S, di)
        return v.reshape(bsz, nc * t, dp)[:, :s, :di]
    return back(ddt), acc[..., :DS], acc[..., DS:], back(dx), da[:di], dstate0


# --- the plain backward against autograd and the JAX package


@pytest.mark.parametrize("shape", [(2, 9, 5), (1, 21, 8)])
@pytest.mark.parametrize("served_a", [False, True])
def test_plain_bwd_matches_autograd_through_the_plain_scan(shape, served_a):
    ins = [torch.from_numpy(v) for v in _draw(*shape, served_a)]
    got = ref.mamba_scan_bwd_ref(*ins)
    live = [t.clone().requires_grad_() for t in ins[:6]]
    want = torch.autograd.grad(ref.mamba_scan_ref(*live), live, tuple(ins[6:]))
    _close(got, want, "autograd through the plain scan")


@pytest.mark.parametrize("shape", [(2, 9, 5), (1, 21, 8)])
def test_plain_bwd_matches_jax_vjp_of_the_oracle(shape):
    """From zero with y's cotangent only, as the oracle starts from zero and
    returns y alone: the gradients of dt, b, c, x and a."""
    arrays = _draw(*shape, state=False)
    ins = [torch.from_numpy(v) for v in arrays]
    got = ref.mamba_scan_bwd_ref(*ins[:7], torch.zeros_like(ins[7]))
    _, vjp = jax.vjp(JR.mamba_scan_ref, *(jnp.asarray(v) for v in arrays[:5]))
    _close(got[:5], vjp(jnp.asarray(arrays[6])), "jax.vjp of the reference's oracle")


def _mixer_params(cfg, jcfg, seed):
    """numpy-drawn leaves of the reference's ``init_mamba`` shapes."""
    shapes = jax.eval_shape(lambda: JM.init_mamba(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)
    out = {}
    for k, sd in shapes.items():
        v = rng.standard_normal(sd.shape) / np.sqrt(sd.shape[0] if len(sd.shape) > 1 else 4)
        if k == "A_log":
            v = np.log(np.arange(1, sd.shape[1] + 1))[None, :] + 0.1 * v
        if k == "dt_bias":
            v = v - 1.0
        out[k] = v.astype(np.float32)
    return out


@pytest.mark.parametrize("s", [24, 131])
def test_mixer_backward_matches_jax_vjp_of_mamba_seq(s):
    """The port's ``mamba_seq`` on the CPU, differentiated by autograd
    through the plain scan, against ``jax.vjp`` of the reference's mixer
    (its chunked ``lax.scan`` under ``jax.checkpoint``) from a given (conv,
    ssm) state, reduced jamba with ``moe=None`` in f32: every parameter's
    gradient, the input's and both states'.  S 131 is no multiple of the
    reference's chunk of 128."""
    served = SERVED["jamba-v0.1-52b"]
    cfg = dataclasses.replace(reduced(get_config("jamba-v0.1-52b")), dtype="float32", **served)
    jcfg = dataclasses.replace(jreduced(jget_config("jamba-v0.1-52b")), dtype="float32",
                               **served)
    params = _mixer_params(cfg, jcfg, s)
    rng = np.random.default_rng(s + 1)
    di, dc = TM.d_inner(cfg), cfg.mamba_d_conv
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    st = (rng.standard_normal((2, dc - 1, di)).astype(np.float32),
          (0.3 * rng.standard_normal((2, di, cfg.mamba_d_state))).astype(np.float32))
    cots = (rng.standard_normal((2, s, cfg.d_model)).astype(np.float32),
            rng.standard_normal(st[0].shape).astype(np.float32),
            rng.standard_normal(st[1].shape).astype(np.float32))
    keys = sorted(params)
    live = [torch.from_numpy(params[k]).requires_grad_() for k in keys]
    tx = torch.from_numpy(x).requires_grad_()
    tst = [torch.from_numpy(v).requires_grad_() for v in st]
    y, (conv, ssm) = TM.mamba_seq(dict(zip(keys, live)), tx, cfg, tuple(tst))
    got = torch.autograd.grad((y, conv, ssm), [*live, tx, *tst],
                              tuple(torch.from_numpy(v) for v in cots))

    def fn(p, x_, conv_, ssm_):
        y_, (c_, h_) = JM.mamba_seq(p, x_, jcfg, (conv_, ssm_))
        return y_, c_, h_
    _, vjp = jax.vjp(fn, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
                     *(jnp.asarray(v) for v in st))
    jp, jx, jconv, jssm = jax.jit(vjp)(tuple(jnp.asarray(v) for v in cots))
    _close(got, [jp[k] for k in keys] + [jx, jconv, jssm], "jax.vjp of mamba_seq")


# --- the kernel's schedule against the plain backward


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("served_a", [False, True])
def test_schedule_matches_plain_backward_and_autograd(shape, served_a):
    ins = [torch.from_numpy(v) for v in _draw(*shape, served_a)]
    got = schedule_bwd(*ins)
    assert [g.shape for g in got] == [t.shape for t in ins[:6]]
    if served_a and shape[1] >= 8:       # the regime where a_t falls to e^-20
        assert float((ins[0][..., None] * ins[4]).min()) < -10
    _close(got, ref.mamba_scan_bwd_ref(*ins), "the plain backward")
    live = [t.clone().requires_grad_() for t in ins[:6]]
    plain = torch.autograd.grad(ref.mamba_scan_ref(*live), live, tuple(ins[6:]))
    _close(got, plain, "autograd through the plain scan")


def test_sizes_tile_the_state():
    """The sizes read from the source: whole sub-chunks, a channel's d_state
    in whole threads, whole warps of 8 channels."""
    assert T % L == 0 and DS % E == 0 and DS // E == 4 and CPB % 8 == 0


# --- the wrapper on CPU tensors


def test_cpu_wrapper_is_the_plain_backward_and_launches_nothing():
    ins = [torch.from_numpy(v) for v in _draw(2, 5, 8)]
    before = launch_counts()
    got = MS.mamba_scan_bwd(*ins)
    want = ref.mamba_scan_bwd_ref(*ins)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # grad mode on a CPU input that requires grad: the plain scan, which
    # autograd differentiates (no refusal, no launch)
    live = [t.clone().requires_grad_() for t in ins[:6]]
    plain = torch.autograd.grad(MS.mamba_scan(*live), live, tuple(ins[6:]))
    _close(plain, want, "autograd through the wrapper")
    assert launch_counts() == before
    dt, bm, cm, x, a, st, dy, dst = ins
    with pytest.raises(ValueError, match="dy must be f32"):
        MS.mamba_scan_bwd(dt, bm, cm, x, a, st, dy[:, :3], dst)
    with pytest.raises(ValueError, match="dstate must be f32"):
        MS.mamba_scan_bwd(dt, bm, cm, x, a, st, dy, dst.double())
    with pytest.raises(ValueError, match="dstate must be f32"):
        MS.mamba_scan_bwd(dt, bm, cm, x, a, st, dy, dst.to("meta"))
    with pytest.raises(ValueError, match="want a"):
        MS.mamba_scan_bwd(dt, bm, cm, x, a[:3].contiguous(), st, dy, dst)
    with pytest.raises(TypeError, match="float32"):
        MS.mamba_scan_bwd(dt, bm.double(), cm, x, a, st, dy, dst)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        MS.mamba_scan_bwd(*(v.to("meta") for v in ins))
    assert launch_counts() == before


def test_autograd_function_passes_the_gradients_through(monkeypatch):
    """``_Scan``'s plumbing on the CPU, with the plain scan standing in for
    the forward launch: its backward is the wrapper's (the plain backward
    for CPU tensors), in the inputs' order, from non-contiguous gradients."""
    monkeypatch.setattr(MS, "_forward", ref.mamba_scan_ref)
    ins = [torch.from_numpy(v) for v in _draw(1, 7, 6)]
    live = [t.clone().requires_grad_() for t in ins[:6]]
    y, final = MS._Scan.apply(*live)
    dy = ins[6].transpose(1, 2).contiguous().transpose(1, 2)     # strided like dy
    got = torch.autograd.grad((y, final), live, (dy, ins[7]))
    _close(got, ref.mamba_scan_bwd_ref(*ins), "the plain backward through _Scan")
    # the final state unused: its gradient arrives as zeros
    (got_x,) = torch.autograd.grad(MS._Scan.apply(*live)[0], [live[3]], ins[6])
    want = ref.mamba_scan_bwd_ref(*ins[:7], torch.zeros_like(ins[7]))[3]
    _close([got_x], [want], "y alone")
