"""The plain versions of the port's two backward kernels
(``kernels/ref.py``: ``flash_attention_bwd_ref``, ``rwkv6_scan_bwd_ref``),
which the card's kernels are held to, against autograd through the port's
forward plain versions and against ``jax.vjp`` of the JAX package's oracles
(``repro/kernels/ref.py``: ``flash_attention_ref`` at ``:11``,
``rwkv6_scan_ref`` at ``:62``), with inputs and cotangents drawn with numpy.

Bars, fixed before measuring: each gradient within 1e-5 of its max |g| (f32
sums in other orders).  No shape has a single key, where dq and dk vanish
in exact arithmetic.  49 s in the driver's 6-worker run (the reference's
eager ``jax.vjp``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as JR  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_bwd  # noqa: E402

BAR = 1e-5
# (b, sq, sk, h, kh, d, causal, window): causal, a window, GQA groups of 1,
# 2 and 4, Sq < Sk ragged (queries at the last Sq keys), a window under
# Sq < Sk, Sq > Sk with no mask (a cross-attention), unmasked Sq = Sk, at
# head dims 64 and 128
FLASH_SHAPES = [(2, 24, 24, 4, 2, 64, True, None), (1, 30, 30, 4, 1, 64, True, 7),
                (2, 13, 37, 4, 4, 128, True, None), (1, 11, 29, 8, 2, 64, True, 9),
                (2, 40, 17, 4, 2, 64, False, None), (1, 19, 19, 2, 2, 128, False, None),
                (1, 33, 33, 8, 2, 128, False, 5)]
# (b, s, h, d): rwkv6-1.6b's head dim 64, and a small one
RWKV_SHAPES = [(2, 9, 3, 8), (1, 21, 2, 64)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module (six test processes
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        top = np.abs(b).max()
        assert top > 0 and np.abs(a - b).max() <= BAR * top, (what, i)


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_attention_bwd_ref(shape):
    b, sq, sk, h, kh, d, causal, window = shape
    rng = np.random.default_rng(sq * sk + d)
    q_np = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k_np, v_np = (rng.standard_normal((b, sk, kh, d)).astype(np.float32) for _ in range(2))
    do_np = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    q, k, v, do = (torch.from_numpy(a) for a in (q_np, k_np, v_np, do_np))
    o = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
    assert [t.shape for t in got] == [q.shape, k.shape, v.shape]
    # the wrapper on CPU tensors is the plain version
    lse = ref.flash_attention_lse_ref(q, k, causal=causal, window=window)
    assert all(torch.equal(a, b_) for a, b_ in zip(
        got, flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)))
    live = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = torch.autograd.grad(flash_attention(*live, causal=causal, window=window), live, do)
    _close(got, plain, "autograd through the plain forward")
    _, vjp = jax.vjp(lambda q_, k_, v_: JR.flash_attention_ref(q_, k_, v_, causal=causal,
                                                               window=window),
                     *(jnp.asarray(a) for a in (q_np, k_np, v_np)))
    _close(got, vjp(jnp.asarray(do_np)), "jax.vjp of the reference's oracle")


@pytest.mark.parametrize("shape", RWKV_SHAPES)
@pytest.mark.parametrize("served_w", [False, True])
def test_rwkv6_scan_bwd_ref(shape, served_w):
    """From a nonzero start state, with nonzero gradients of out and of the
    final state; decays in (0, 1), or near 0.98 as the served model's."""
    b, s, h, d = shape
    rng = np.random.default_rng(s + d + served_w)
    r_np, k_np, v_np = (0.5 * rng.standard_normal((b, s, h, d)) for _ in range(3))
    if served_w:
        w_np = np.exp(-np.exp(-4.0 + 0.5 * rng.standard_normal((b, s, h, d))))
    else:
        w_np = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, h, d))))
    u_np = 0.3 * rng.standard_normal((h, d))
    st_np = 0.2 * rng.standard_normal((b, h, d, d))
    dout_np, dst_np = rng.standard_normal((b, s, h, d)), rng.standard_normal((b, h, d, d))
    ins = [a.astype(np.float32) for a in (r_np, k_np, v_np, w_np, u_np, st_np)]
    dout, dst = (torch.from_numpy(a.astype(np.float32)) for a in (dout_np, dst_np))
    tins = [torch.from_numpy(a) for a in ins]
    got = ref.rwkv6_scan_bwd_ref(*tins, dout, dst)
    assert [t.shape for t in got] == [t.shape for t in tins]
    assert all(torch.equal(a, b_) for a, b_ in zip(got, rwkv6_scan_bwd(*tins, dout, dst)))
    live = [t.clone().requires_grad_() for t in tins]
    plain = torch.autograd.grad(rwkv6_scan(*live), live, (dout, dst))
    _close(got, plain, "autograd through the plain scan")
    _, vjp = jax.vjp(JR.rwkv6_scan_ref, *(jnp.asarray(a) for a in ins))
    _close(got, vjp((jnp.asarray(dout.numpy()), jnp.asarray(dst.numpy()))),
           "jax.vjp of the reference's oracle")
