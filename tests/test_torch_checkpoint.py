"""The port's checkpoints (``repro_torch.training.checkpoint``) against the
JAX package's (``repro.training.checkpoint``): one flat npz, ``leaf_{i}`` in
``jax.tree_util``'s leaf order, bf16 saved as f32.  A file written by either
package restores in the other, leaf for leaf and bit for bit (bf16 -> f32 ->
bf16 is exact); reduced llama3-8b in f32 and bf16, the reference's weights
carried over by ``transformer_params_from_numpy``.  A few seconds.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import reduced as jreduced  # noqa: E402
from repro.training import checkpoint as JC  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import reduced  # noqa: E402
from repro_torch.params import transformer_params_from_numpy  # noqa: E402
from repro_torch.training import checkpoint as C  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

DTYPES = ["float32", "bfloat16"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module (six test processes
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype):
    return (reduced(get_config("llama3-8b"), dtype=dtype),
            jreduced(jget_config("llama3-8b"), dtype=dtype))


def _reference_params(dtype):
    _, jcfg = _cfgs(dtype)
    return jax.jit(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))()


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_reference_checkpoint_restores_in_the_port(tmp_path, dtype):
    cfg, _ = _cfgs(dtype)
    jp = _reference_params(dtype)
    path = str(tmp_path / "ref.npz")
    JC.save(path, jp)
    want = transformer_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    like = T.init_params(1, cfg, device="cpu")
    got = C.restore(path, like)
    assert list(got) == list(like)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_port_checkpoint_restores_in_the_reference(tmp_path, dtype):
    cfg, jcfg = _cfgs(dtype)
    params = T.init_params(3, cfg, device="cpu")
    path = str(tmp_path / "port.npz")
    C.save(path, params)
    like = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
    got = JC.restore(path, like)
    back = transformer_params_from_numpy(cfg, jax.tree.map(np.asarray, got), device="cpu")
    for g, w in zip(tree_leaves(back), tree_leaves(params)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert jax.tree.map(lambda a: a.dtype, got) == jax.tree.map(lambda a: a.dtype, like)


def test_leaf_order_is_the_reference_s(tmp_path):
    """Keys sorted at every level, lists in order; ints kept as they are."""
    tree = {"b": torch.arange(3, dtype=torch.int32),
            "a": [torch.ones(2), {"z": torch.zeros(1), "y": torch.full((4,), 2.0)}]}
    jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree,
                         is_leaf=lambda t: isinstance(t, torch.Tensor))
    port, ref = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    C.save(port, tree)
    JC.save(ref, jtree)
    with np.load(port) as p, np.load(ref) as r:
        for i in range(4):
            assert p[f"leaf_{i}"].dtype == r[f"leaf_{i}"].dtype
            assert np.array_equal(p[f"leaf_{i}"], r[f"leaf_{i}"])
    got = C.restore(ref, tree)
    assert list(got) == ["b", "a"] and list(got["a"][1]) == ["z", "y"]
    for g, w in zip(tree_leaves(got), tree_leaves(tree)):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_restore_refuses_another_shape(tmp_path):
    cfg, _ = _cfgs("float32")
    path = str(tmp_path / "port.npz")
    C.save(path, T.init_params(0, cfg, device="cpu"))
    wider = reduced(get_config("llama3-8b"), dtype="float32", d_ff=128)
    with pytest.raises(ValueError, match="has shape"):
        C.restore(path, T.init_params(0, wider, device="cpu"))


def test_save_is_atomic_and_overwrites(tmp_path):
    path = str(tmp_path / "sub" / "ck.npz")
    C.save(path, {"w": torch.zeros(3)})
    C.save(path, {"w": torch.ones(3)})
    assert sorted(os.listdir(tmp_path / "sub")) == ["ck.npz"]
    assert torch.equal(C.restore(path, {"w": torch.empty(3)})["w"], torch.ones(3))
