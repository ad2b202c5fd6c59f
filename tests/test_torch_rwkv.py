"""The port's RWKV-6 scan (its plain version on the CPU) and time-mix against
the JAX package: the Pallas kernel in interpret mode, its ``ref`` oracle and
``repro.models.rwkv``."""
import dataclasses

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
from repro_torch.kernels import launch_counts, ops  # noqa: E402
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
