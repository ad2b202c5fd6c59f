"""The port's RWKV-6 scan (its plain version on the CPU) and time-mix against
the JAX package: the Pallas kernel in interpret mode, its ``ref`` oracle and
``repro.models.rwkv``."""
import dataclasses
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_scan  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro.models.common import reduced as jreduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import launch_counts, ops, ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan  # noqa: E402
from repro_torch.models import rwkv as TR  # noqa: E402
from repro_torch.models.common import reduced  # noqa: E402
from repro_torch.params import _leaf  # noqa: E402

# tests/test_kernels.py's RWKV_CASES: b, s, h, d, chunk
RWKV_CASES = [(2, 128, 2, 64, 64), (1, 64, 4, 32, 16), (1, 256, 1, 64, 128)]
TOL = 1e-4   # as tests/test_kernels.py holds the TPU kernel to its ref


def _inputs(b, s, h, d, seed, *, state=False):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, s, h, d)) for _ in range(3))
    w = 1 / (1 + np.exp(-rng.standard_normal((b, s, h, d))))
    u = 0.3 * rng.standard_normal((h, d))
    st = (0.2 * rng.standard_normal((b, h, d, d)) if state else np.zeros((b, h, d, d)))
    return [a.astype(np.float32) for a in (r, k, v, w, u, st)]


@pytest.mark.parametrize("case", RWKV_CASES)
def test_plain_scan_matches_pallas_kernel_from_zero(case):
    b, s, h, d, chunk = case
    arrays = _inputs(b, s, h, d, s + d)
    out, st = rwkv6_scan(*(torch.from_numpy(a) for a in arrays))
    jout, jst = pallas_scan(*(jnp.asarray(a) for a in arrays[:5]), chunk=chunk, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=TOL)


@pytest.mark.parametrize("s", [1, 37])
def test_plain_scan_matches_ref_from_a_given_state(s):
    arrays = _inputs(2, s, 3, 32, s, state=True)
    out, st = rwkv6_scan(*(torch.from_numpy(a) for a in arrays))
    jout, jst = jref.rwkv6_scan_ref(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=TOL)


def test_scan_splits_at_any_step():
    """Two runs chained through the state equal one run: how decode carries
    the prefill's state."""
    r, k, v, w, u, st = (torch.from_numpy(a) for a in _inputs(1, 20, 2, 32, 5, state=True))
    out, final = rwkv6_scan(r, k, v, w, u, st)
    o1, s1 = rwkv6_scan(*(a[:, :13].contiguous() for a in (r, k, v, w)), u, st)
    o2, s2 = rwkv6_scan(*(a[:, 13:].contiguous() for a in (r, k, v, w)), u, s1)
    torch.testing.assert_close(torch.cat([o1, o2], 1), out, rtol=0, atol=1e-6)
    torch.testing.assert_close(s2, final, rtol=0, atol=1e-6)


def test_cpu_scan_launches_nothing_and_checks_inputs():
    r, k, v, w, u, st = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 32, 0))
    before = launch_counts()
    out, _ = ops.wkv_op(r, k, v, w, u)      # zero state, as the reference's op
    assert torch.equal(out, rwkv6_scan(r, k, v, w, u, st)[0])
    assert launch_counts() == before
    with pytest.raises(ValueError, match="at least one step"):
        rwkv6_scan(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u, st)
    with pytest.raises(ValueError, match="want u"):
        rwkv6_scan(r, k, v, w, u[:1], st)
    with pytest.raises(TypeError, match="float32"):
        rwkv6_scan(r.double(), k, v, w, u, st)
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_scan(r, k, v, w, u, st.transpose(2, 3))


def _fma(a, b, c):
    """a * b + c rounded once to f32, as ``fmaf`` rounds it (through f64,
    where the product of two f32 values is exact)."""
    return (a.double() * b.double() + c.double()).float()


# the lanes a state column is split over in csrc/rwkv6_scan.cu, as built
_CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
       / "rwkv6_scan.cu").read_text()
LANES = int(re.search(r"constexpr int LANES = (\d+);", _CU).group(1))


def _wkv_kernel_numerics(r, k, v, w, u, state, lanes=LANES):
    """The arithmetic of ``csrc/rwkv6_scan.cu``, written out in PyTorch (CPU).
    a_t = sum_i r_i (u_i k_i): 16 partials of 4 rows each (a product, then 3
    fmas in ascending row), added pairwise as xor shuffles 1, 2, 4, 8 add
    them.  Lane q of a column holds rows 4 (m lanes + q) + e; its partial of
    sum_i r_i S_ij runs over them in that order (fmas from 0), the lanes'
    partials are added pairwise (xor 1, then 2), and out_j = fma(v_j, a_t,
    sum).  Then S_ij = fma(w_i, S_ij, k_i v_j), the product rounded."""
    b, s, h, d = r.shape
    rows = torch.arange(d).view(d // (4 * lanes), lanes, 4).transpose(0, 1).reshape(lanes, -1)
    st, outs = state.clone(), []
    for t in range(s):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]       # (B, H, D)
        uk = u * kt
        p = rt[..., 0::4] * uk[..., 0::4]
        for e in range(1, 4):
            p = _fma(rt[..., e::4], uk[..., e::4], p)
        while p.shape[-1] > 1:
            p = p[..., 0::2] + p[..., 1::2]
        acc = torch.zeros((b, h, lanes, d))
        for n in range(d // lanes):
            i = rows[:, n]                                        # lane q's n-th row
            acc = _fma(rt[..., i, None], st[:, :, i, :], acc)
        while acc.shape[2] > 1:
            acc = acc[:, :, 0::2] + acc[:, :, 1::2]
        outs.append(_fma(vt, p, acc[:, :, 0]))
        st = _fma(wt[..., :, None], st, kt[..., :, None] * vt[..., None, :])
    return torch.stack(outs, dim=1), st


def _kernel_inputs(served_w, b, s, h, d, seed):
    """chip_smoke.py's Z3 inputs from numpy: w = exp(-exp(N(0, 1) - 1)) and
    u = 0.3 N(0, 1), or the served model's decays, w = exp(-exp(-4 + 0.5
    N(0, 1))) near 0.98, and u = 0.1 N(0, 1), as models/rwkv.py's decay_base
    and bonus make them; a given state of 0.2 N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, s, h, d)) for _ in range(3))
    z = rng.standard_normal((b, s, h, d))
    w = np.exp(-np.exp(-4.0 + 0.5 * z)) if served_w else np.exp(-np.exp(z - 1.0))
    u = (0.1 if served_w else 0.3) * rng.standard_normal((h, d))
    st = 0.2 * rng.standard_normal((b, h, d, d))
    return [a.astype(np.float32) for a in (r, k, v, w, u, st)]


# RWKV_CASES[0]: b 2, s 128, h 2, d 64, the Pallas kernel's chunk 64
@pytest.mark.parametrize("served_w", [False, True])
def test_kernel_numerics_match_pallas_kernel_and_plain_scan(served_w):
    """The CUDA kernel's roundings against the Pallas kernel (interpret
    mode, from zero) and the plain scan (from a given state) at 1e-4 of
    max, the bar chip_smoke.py and the card tests hold the kernel to."""
    b, s, h, d, chunk = RWKV_CASES[0]
    arrays = _kernel_inputs(served_w, b, s, h, d, seed=7)
    r, k, v, w, u, st = (torch.from_numpy(a) for a in arrays)
    if served_w:    # the state sums some 50 steps: w near 0.98
        assert 0.95 < float(w.mean()) < 0.99
    got, got_st = _wkv_kernel_numerics(r, k, v, w, u, torch.zeros_like(st))
    jout, jst = pallas_scan(*(jnp.asarray(a) for a in arrays[:5]), chunk=chunk, interpret=True)
    jout, jst = np.asarray(jout), np.asarray(jst)
    assert np.abs(got.numpy() - jout).max() <= TOL * np.abs(jout).max()
    assert np.abs(got_st.numpy() - jst).max() <= TOL * np.abs(jst).max()
    got, got_st = _wkv_kernel_numerics(r, k, v, w, u, st)
    want, want_st = ref.rwkv6_scan_ref(r, k, v, w, u, st)
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())
    assert float((got_st - want_st).abs().max()) <= TOL * float(want_st.abs().max())


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_kernel_numerics_split_the_rows_and_keep_the_recurrence(lanes):
    """Each lane split takes every row once: with S = 1 and a zero bonus
    the emulation's out is a sum of the same products as the plain scan's,
    and the state update is the plain scan's bit for bit."""
    r, k, v, w, u, st = (torch.from_numpy(a) for a in _kernel_inputs(False, 2, 1, 3, 64, 3))
    got, got_st = _wkv_kernel_numerics(r, k, v, w, torch.zeros_like(u), st, lanes=lanes)
    want = torch.einsum("bhk,bhkv->bhv", r[:, 0].double(), st.double())
    torch.testing.assert_close(got[:, 0].double(), want, rtol=0, atol=1e-5)
    want_st = _fma(w[:, 0, ..., None], st, k[:, 0, ..., None] * v[:, 0, :, None, :])
    assert torch.equal(got_st, want_st)


def test_time_mix_matches_reference_from_a_given_state():
    cfg = dataclasses.replace(reduced(get_config("rwkv6-1.6b")), dtype="float32")
    jcfg = dataclasses.replace(jreduced(jget_config("rwkv6-1.6b")), dtype="float32")
    jp = JR.init_time_mix(jax.random.PRNGKey(4), jcfg)
    tp = {k: _leaf(np.asarray(a), "cpu") for k, a in jp.items()}
    rng = np.random.default_rng(1)
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    prev = rng.standard_normal((2, d)).astype(np.float32)
    st = (0.1 * rng.standard_normal((2, d // hd, hd, hd))).astype(np.float32)
    out, last, state = TR.time_mix(tp, *(torch.from_numpy(a) for a in (x, prev, st)), cfg)
    jout, jlast, jstate = JR.time_mix(jp, *(jnp.asarray(a) for a in (x, prev, st)), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), atol=TOL)
