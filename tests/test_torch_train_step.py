"""The port's AdamW (``training/optimizer.py``: ``OptConfig``,
``adamw_init``, ``global_norm``, ``adamw_update``) and train step
(``training/train.py``) against the JAX package's, with the weights and
batches of ``tests/test_torch_train.py`` (numpy draws into both trees).

The reference's ``adamw_update`` runs eagerly, op by op: under ``jax.jit``
XLA fuses a bf16 product into the cast to f32 that follows it and skips the
bf16 rounding the code writes (``g * scale.astype(g.dtype)``), which eager
JAX and the port both do.  The train step's losses, an f32 model, are taken
from the jitted reference.

Bars, fixed before measuring, relative to the largest magnitude of what is
compared: parameters, master copies and moments within 1e-6 (f32
arithmetic; the global norm is summed in another order, so the clip scale
may sit a last bit apart), ``t`` equal; ``make_train_step``'s losses over 3
steps within 1e-4.  bf16 moments: a moment whose f32 value sits within that
last bit of a bf16 rounding boundary lands on the neighbouring bf16 value,
so they are held within one bf16 step (2**-8 of max), and the parameters
within 1e-6 plus 2**-7 of the reference's step (a moment one step off moves
the update by at most 2**-8 through m and 2**-9 through sqrt v).  41 s in
the driver's 6-worker run.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.training import optimizer as JO  # noqa: E402
from repro.training import train as JTR  # noqa: E402
from repro_torch.params import transformer_params_from_numpy  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training import train as TR  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_train import _both, _cfgs, _gap, _pairs, numpy_params  # noqa: E402

# each OptConfig variant adamw_update is held to, with its parameters'
# dtype: clip on, off and tight, weight decay, bf16 moments, an f32 master
# copy of bf16 parameters with the clip off and with it active
OPT_VARIANTS = {
    "default": (dict(), "float32"),
    "no_clip_decay": (dict(grad_clip=None, weight_decay=0.1), "float32"),
    "tight_clip": (dict(grad_clip=1e-3), "float32"),
    "bf16_moments": (dict(moment_dtype="bfloat16", weight_decay=0.05), "float32"),
    "master_fp32": (dict(master_fp32=True, weight_decay=0.1, grad_clip=None), "bfloat16"),
    "master_fp32_clipped": (dict(master_fp32=True, grad_clip=1e-3), "bfloat16"),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module (six test processes
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_global_norm_equals_the_reference():
    _, cfg = _cfgs("deepseek-moe-16b")
    p_np = numpy_params(cfg, seed=3)
    got = float(O.global_norm(transformer_params_from_numpy(cfg, p_np, device="cpu")))
    want = float(jax.jit(JO.global_norm)(jax.tree.map(jnp.asarray, p_np)))
    assert abs(got - want) <= 1e-6 * want


@pytest.mark.parametrize("variant", list(OPT_VARIANTS))
def test_adamw_update_equals_the_reference(variant):
    """Two steps of ``adamw_update`` from the same parameters and
    gradients: the port's in-place update against the reference's pure
    one."""
    opt, dtype = OPT_VARIANTS[variant]
    oc, joc = O.OptConfig(**opt), JO.OptConfig(**opt)
    _, cfg = _cfgs("llama3.2-3b", dtype)
    p_np = numpy_params(cfg)
    params = transformer_params_from_numpy(cfg, p_np, device="cpu")
    jparams = jax.tree.map(jnp.asarray, p_np)
    state, jstate = O.adamw_init(params, oc), JO.adamw_init(jparams, joc)
    rng = np.random.default_rng(1)
    for step in range(2):
        g_np = jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape)).astype(a.dtype),
                            p_np)
        grads = transformer_params_from_numpy(cfg, g_np, device="cpu")
        before = [p.data_ptr() for p in tree_leaves(params)]
        prev = {path: np.asarray(w, np.float32) for path, _, w in _pairs(params, jparams)}
        params, state = O.adamw_update(params, grads, state, oc)
        assert [p.data_ptr() for p in tree_leaves(params)] == before     # in place
        jparams, jstate = JO.adamw_update(jparams, jax.tree.map(jnp.asarray, g_np), jstate,
                                          joc)
        assert int(state["t"]) == int(jstate["t"]) == step + 1
        bf16_moments = opt.get("moment_dtype") == "bfloat16"
        keys = ("m", "v", "master") if "master" in state else ("m", "v")
        for key in keys:
            for path, got, want in _pairs(state[key], jstate[key]):
                assert got.dtype == getattr(torch, str(want.dtype)), (key, path)
                bar = 2.0 ** -8 if bf16_moments and key != "master" else 1e-6
                assert _gap(got.float().numpy(), np.asarray(want, np.float32)) <= bar, (
                    key, path)
        for path, got, want in _pairs(params, jparams):
            assert got.dtype == getattr(torch, str(want.dtype)), path
            want = np.asarray(want, np.float32)
            bar = 1e-6 * np.abs(want).max()
            if bf16_moments:
                bar += 2.0 ** -7 * np.abs(want - prev[path]).max()
            assert np.abs(got.float().numpy() - want).max() <= bar, path


@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-1.6b", "deepseek-moe-16b",
                                  "whisper-tiny"])
def test_train_step_losses_equal_the_reference(arch):
    """Three steps of ``make_train_step`` from the same state and batch."""
    jcfg, cfg = _cfgs(arch)
    (params, batch), (jparams, jbatch) = _both(cfg, jcfg)
    opt = dict(lr=1e-3, weight_decay=0.01)
    state = O.adamw_init(params, O.OptConfig(**opt))
    jstate = JO.adamw_init(jparams, JO.OptConfig(**opt))
    step = TR.make_train_step(cfg, O.OptConfig(**opt))
    jstep = jax.jit(JTR.make_train_step(jcfg, JO.OptConfig(**opt)))
    for _ in range(3):
        params, state, metrics = step(params, state, batch)
        jparams, jstate, jmetrics = jstep(jparams, jstate, jbatch)
        assert set(metrics) == set(jmetrics) == {"loss", "ce", "aux"}
        assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= 1e-4 * abs(
            float(jmetrics["loss"]))
    assert int(state["t"]) == 3


def test_init_train_state_and_its_struct_agree():
    """``init_train_state`` on the CPU has the tree, shapes and dtypes of
    ``train_state_struct``'s ``meta`` tensors."""
    _, cfg = _cfgs("whisper-tiny", "bfloat16")
    oc = O.OptConfig(moment_dtype="bfloat16", master_fp32=True)
    params, state = TR.init_train_state(0, cfg, oc, device="cpu")
    sparams, sstate = TR.train_state_struct(cfg, oc)
    for got, want in zip(tree_leaves((params, state)), tree_leaves((sparams, sstate))):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert got.device.type == "cpu" and want.device.type == "meta"
    assert int(state["t"]) == 0 and all(float(m.abs().max()) == 0 for m in tree_leaves(
        state["m"]))


def test_adamw_update_in_slices_changes_no_value(monkeypatch):
    """``adamw_update`` takes a large leaf ``ADAMW_CHUNK`` elements at a time
    (its f32 temporaries stay small); the update is elementwise, so two
    steps with slices of 100 elements give the bits of two with whole
    leaves."""
    torch.manual_seed(0)
    params = {"a": torch.randn(70, 33, 5).bfloat16(), "b": torch.randn(7)}
    grads = {k: torch.randn_like(v) for k, v in params.items()}
    oc = O.OptConfig(weight_decay=0.1, master_fp32=True)
    runs = []
    for chunk in (O.ADAMW_CHUNK, 100):
        monkeypatch.setattr(O, "ADAMW_CHUNK", chunk)
        p = {k: v.clone() for k, v in params.items()}
        state = O.adamw_init(p, oc)
        for _ in range(2):
            p, state = O.adamw_update(p, grads, state, oc)
        runs.append(tree_leaves((p, state)))
    assert len(O._chunks(params["a"])) == 70            # 165 elements a row, 1 a slice
    monkeypatch.setattr(O, "ADAMW_CHUNK", 1 << 26)
    assert len(O._chunks(params["a"])) == 1
    assert all(torch.equal(a, b) for a, b in zip(*runs))
