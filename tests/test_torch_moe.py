"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
package's (``repro/models/moe.py``) on the CPU, with the same weights drawn
with numpy, at the served capacity factor (the config's 1.25; no case here
changes it).

Bars, fixed before measuring: the output within 1e-5 of max |out| in f32
and 2e-2 in bf16 (the two frameworks round the experts' products and
``silu`` at other places), the aux loss within 1e-6, and the routing (each
token's experts in order, and which (token, expert) pairs are kept)
exactly equal.  The reference keeps its routing inside ``moe_ffn``, so
``_ref_routing`` writes out its lines 57-73 in JAX as the oracle.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import moe as JM  # noqa: E402
from repro.models.common import MoEConfig as JMoEConfig  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.common import MoEConfig  # noqa: E402

D = 32
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
AUX_TOL = 1e-6
# (n_experts, top_k, d_expert, n_shared): deepseek's routing (64 experts,
# top-6, 2 shared) at a narrow width, and jamba's (16, top-2, no shared)
MOES = {"deepseek": (64, 6, 16, 2), "jamba": (16, 2, 16, 0)}
# case: (moe, batch, seq, group_chunk, zero router)
CASES = {
    "drops": ("deepseek", 2, 64, M.GROUP_CHUNK, False),
    "drops_jamba": ("jamba", 2, 40, M.GROUP_CHUNK, False),
    "zero_router": ("deepseek", 2, 24, M.GROUP_CHUNK, True),
    "decode": ("deepseek", 4, 1, M.GROUP_CHUNK, False),
    "ragged_groups": ("jamba", 2, 50, 16, False),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module (six test processes
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name):
    e, k, f, shared = MOES[name]
    return (MoEConfig(n_experts=e, top_k=k, d_expert=f, n_shared=shared),
            JMoEConfig(n_experts=e, top_k=k, d_expert=f, n_shared=shared))


def _weights(m, seed, zero_router=False):
    """The reference's tree as f32 numpy, each matrix at 1/sqrt(fan_in)."""
    rng = np.random.default_rng(seed)

    def dense(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    e, f = m.n_experts, m.d_expert
    p = {"router": np.zeros((D, e), np.float32) if zero_router else dense(D, e),
         "w_gate": dense(e, D, f), "w_up": dense(e, D, f), "w_down": dense(e, f, D)}
    if m.n_shared:
        width = f * m.n_shared
        p["shared"] = {"w_gate": dense(D, width), "w_up": dense(D, width),
                       "w_down": dense(width, D)}
    return p


def _to_torch(p, dtype):
    """The router stays f32, as the reference holds it; the rest in ``dtype``
    (both frameworks round f32 to bf16 to nearest even: the same bits)."""
    return {k: (_to_torch(v, dtype) if isinstance(v, dict) else
                torch.from_numpy(v).to(torch.float32 if k == "router" else dtype))
            for k, v in p.items()}


def _to_jax(p, dtype):
    return {k: (_to_jax(v, dtype) if isinstance(v, dict) else
                jnp.asarray(v).astype(jnp.float32 if k == "router" else dtype))
            for k, v in p.items()}


def _ref_routing(x, p, m, group_chunk):
    """``repro/models/moe.py:57-73``: each token's experts (G,T,k) and which
    of its pairs are kept (G,T,k)."""
    b, s, d = x.shape
    chunk = min(group_chunk, s)
    while s % chunk:
        chunk -= 1
    g = b * (s // chunk)
    probs = jax.nn.softmax(x.reshape(g, chunk, d).astype(jnp.float32) @ p["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, m.top_k)
    onehot = jax.nn.one_hot(idx, m.n_experts, dtype=jnp.int32)
    flat = onehot.reshape(g, chunk * m.top_k, m.n_experts)
    pos = (jnp.cumsum(flat, axis=1) * flat - 1).reshape(g, chunk, m.top_k, m.n_experts)
    keep = (pos >= 0) & (pos < JM.group_capacity(chunk, m))
    return idx, keep.any(-1)


@pytest.fixture(scope="module")
def reference():
    """The reference's ``moe_ffn`` and routing under ``jax.jit``, one compile
    a shape (run op by op, each JAX primitive compiles on its own)."""
    fns = {}

    def run(x, p, m, group_chunk):
        key = (x.shape, x.dtype, m, group_chunk)
        if key not in fns:
            fns[key] = jax.jit(lambda x, p: (JM.moe_ffn(x, p, m, group_chunk=group_chunk),
                                             _ref_routing(x, p, m, group_chunk)))
        return fns[key](x, p)
    return run


def _run_case(case, dtype, reference):
    name, b, s, group_chunk, zero_router = CASES[case]
    m, jm = _configs(name)
    p = _weights(m, seed=len(case), zero_router=zero_router)
    x = np.random.default_rng(s).standard_normal((b, s, D)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx, tp = torch.from_numpy(x).to(tdt), _to_torch(p, tdt)
    out, aux = M.moe_ffn(tx, tp, m, group_chunk=group_chunk)
    r = M.route(M.groups(tx, group_chunk), tp["router"], m)
    (jout, jaux), (jidx, jkeep) = reference(jnp.asarray(x).astype(jdt), _to_jax(p, jdt), jm,
                                            group_chunk)
    return {"m": m, "out": out, "aux": aux, "route": r,
            "dropped": int(M.dropped_pairs(tx, tp, m, group_chunk=group_chunk)),
            "jout": np.asarray(jout.astype(jnp.float32)), "jaux": float(jaux),
            "jidx": np.asarray(jidx), "jkeep": np.asarray(jkeep)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_equals_the_reference(case, dtype, reference):
    got = _run_case(case, dtype, reference)
    out, want = got["out"], got["jout"]
    assert out.dtype == getattr(torch, dtype) and out.shape == want.shape
    err = float(np.abs(out.float().numpy() - want).max())
    assert err <= TOL[dtype] * float(np.abs(want).max()), err
    assert got["aux"].dtype == torch.float32
    assert abs(float(got["aux"]) - got["jaux"]) <= AUX_TOL
    # the routing exactly: the experts in the reference's order, the same pairs kept
    np.testing.assert_array_equal(got["route"].experts.numpy(), got["jidx"])
    np.testing.assert_array_equal((got["route"].slot >= 0).numpy(), got["jkeep"])
    assert got["dropped"] == int((~got["jkeep"]).sum())


@pytest.mark.parametrize("case", ["drops", "drops_jamba", "zero_router"])
def test_the_served_capacity_drops_pairs(case, reference):
    """At the served capacity factor these groups overflow an expert: the
    drop path is exercised, and every kept slot is below the capacity."""
    got = _run_case(case, "float32", reference)
    r, m = got["route"], got["m"]
    assert got["dropped"] > 0
    assert int(r.slot.max()) == M.group_capacity(r.slot.shape[1], m) - 1


def test_a_tie_goes_to_the_lower_expert_index(reference):
    """A zero router makes every probability equal: ``jax.lax.top_k`` then
    takes experts 0..k-1 in order, and so must the port (``torch.topk``
    on the CPU takes others).  Experts 0..k-1 take every token, so all but
    the first ``capacity`` tokens of a group are dropped, at every choice."""
    got = _run_case("zero_router", "float32", reference)
    r, m = got["route"], got["m"]
    g, t, k = r.experts.shape
    assert torch.equal(r.experts, torch.arange(k).expand(g, t, k))
    cap = M.group_capacity(t, m)
    assert torch.equal(r.slot >= 0, (torch.arange(t) < cap)[None, :, None].expand(g, t, k))
    assert got["dropped"] == g * (t - cap) * k


def test_a_decode_step_drops_nothing(reference):
    """One token is a group of its own with one slot an expert, and it picks
    each expert at most once."""
    got = _run_case("decode", "float32", reference)
    assert got["route"].slot.shape[1] == 1
    assert got["dropped"] == 0 and torch.equal(got["route"].slot, torch.zeros_like(
        got["route"].slot))


def test_groups_take_the_largest_divisor_up_to_the_chunk():
    x = torch.zeros((2, 50, 4))
    assert M.groups(x, 16).shape == (10, 10, 4)       # 50 = 5 x 10
    assert M.groups(x, 2048).shape == (2, 50, 4)
    assert M.groups(torch.zeros((3, 1, 4))).shape == (3, 1, 4)
    for name in MOES:
        m, jm = _configs(name)
        for t in (1, 10, 16, 50, 256, 2000, 2048):
            assert M.group_capacity(t, m) == JM.group_capacity(t, jm)


@pytest.mark.parametrize("n_shared", [0, 2])
def test_shared_experts_add_a_swiglu_of_the_whole_input(n_shared, reference):
    """The shared experts run on the ungrouped input, at width F * n_shared;
    without them the output is the routed experts' alone."""
    m, jm = (dataclasses.replace(c, n_shared=n_shared) for c in _configs("deepseek"))
    p = _weights(m, seed=5)
    x = np.random.default_rng(5).standard_normal((2, 24, D)).astype(np.float32)
    out, _ = M.moe_ffn(torch.from_numpy(x), _to_torch(p, torch.float32), m)
    (want, _), _ = reference(jnp.asarray(x), _to_jax(p, jnp.float32), jm, M.GROUP_CHUNK)
    want = np.asarray(want)
    assert float(np.abs(out.numpy() - want).max()) <= TOL["float32"] * float(np.abs(want).max())
    if n_shared:
        routed, _ = M.moe_ffn(torch.from_numpy(x), _to_torch(
            {k: v for k, v in p.items() if k != "shared"}, torch.float32),
            dataclasses.replace(m, n_shared=0))
        assert float((out - routed).abs().max()) > 0.1 * float(out.abs().max())


@pytest.mark.parametrize("name", list(MOES))
def test_init_moe_builds_the_reference_tree(name):
    m, jm = _configs(name)
    want = jax.eval_shape(lambda: JM.init_moe(jax.random.PRNGKey(0), D, jm, jnp.bfloat16))
    for device in ("cpu", "meta"):
        got = M.init_moe(None if device == "meta" else torch.Generator().manual_seed(0), D, m,
                         torch.bfloat16, torch.device(device))
        assert set(got) == set(want)
        for key, spec in want.items():
            leaves = got[key] if isinstance(got[key], dict) else {"": got[key]}
            specs = spec if isinstance(spec, dict) else {"": spec}
            for k, t in leaves.items():
                assert tuple(t.shape) == specs[k].shape, (key, k)
                assert str(t.dtype).split(".")[-1] == str(specs[k].dtype), (key, k)
                assert t.is_contiguous()
    # w_down at the reference's scale: drawn (E, D, F) at 1/sqrt(D), then swapped
    w = M.init_moe(torch.Generator().manual_seed(0), 256, m, torch.float32, "cpu")
    assert abs(float(w["w_down"].std()) * 16 - 1) < 0.05
