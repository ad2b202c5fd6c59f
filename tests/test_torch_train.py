"""Zoo training in the port (``models/transformer.loss_fn``, the AdamW of
``training/optimizer.py`` and ``training/train.py``) against the JAX
package's, with the same weights: every arch of the registry, reduced and
in f32, its parameters drawn with numpy (:func:`numpy_params`) into both
trees, the same numpy batch.  The reference's functions run under
``jax.jit``.

Bars, fixed before measuring: the loss within 1e-5 relative; every gradient
leaf within 1e-4 of its max |g| (f32 sums in other orders, the bar of
``tests/test_torch_study.py``'s ``fit_loss``; ``GRAD_BAR_HYBRID`` for the
hybrid family, whose gradient the reference itself reproduces no closer);
each MoE layer's experts equal to the reference's top-k of the same input,
and equal again when the layer's group is recomputed in the backward.  The
optimizer and the train step: ``tests/test_torch_train_step.py``; the MoE
and hybrid archs: ``tests/test_torch_train_moe.py``.  75 s in the driver's
6-worker run with them; the three files together take 60 s in one process.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS, get_config as jget_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import reduced as jreduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import reduced  # noqa: E402
from repro_torch.params import transformer_params_from_numpy  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

SEQ, BATCH, CHUNK = 32, 2, 16
# the gradient bar, relative to each leaf's max |g|; the hybrid family
# (Mamba mixers, 8 layers in the reduced jamba) at GRAD_BAR_HYBRID: its f32
# gradient is so conditioned that the reference's own jitted and eager runs
# part by 7.3e-5 of max at ('layers', 'l0', 'ffn', 'w_gate') (seed 0)
GRAD_BAR, GRAD_BAR_HYBRID = 1e-4, 3e-4

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module (six test processes
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jreduced(jget_config(arch)), dtype=dtype),
            dataclasses.replace(reduced(get_config(arch)), dtype=dtype))


def numpy_params(cfg, seed=0) -> dict:
    """A parameter tree for ``cfg`` drawn with numpy in its leaves' dtypes:
    norm scales 1 + 0.1 N(0, 1), other vectors (biases, mixes, decays) and
    Mamba's A_log 0.1 N(0, 1), matrices N(0, 1) / sqrt(fan-in)."""
    rng = np.random.default_rng(seed)

    def draw(spec, path):
        if isinstance(spec, dict):
            return {k: draw(spec[k], path + (k,)) for k in spec}
        shape = tuple(spec.shape)
        core = shape[1:] if "layers" in path else shape        # no group axis
        a = rng.standard_normal(shape)
        if len(core) == 1 or path[-1] in ("A_log", "maa_base"):
            norm = path[-1] in ("w", "ln_x") and len(core) == 1
            a = 1.0 + 0.1 * a if norm else 0.1 * a
        else:
            a = a / np.sqrt(core[-2])
        return a.astype(np.float32).astype(jnp.dtype(str(spec.dtype).split(".")[-1]))
    return draw(T.param_spec(cfg), ())


def numpy_batch(cfg, b=BATCH, s=SEQ, seed=0) -> dict:
    """tests/test_models_smoke.py's batch, as numpy."""
    rng = np.random.default_rng(seed)
    st = s - (cfg.n_patches if cfg.family == "vlm" else 0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, st)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(size=(b, cfg.n_patches, cfg.d_frontend))
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(b, cfg.n_frames, cfg.d_frontend))
    batch["labels"] = rng.integers(0, cfg.vocab, (b, st)).astype(np.int32)
    return {k: v if v.dtype == np.int32 else v.astype(cfg.dtype) for k, v in batch.items()}


def _both(cfg, jcfg, seed=0):
    p_np, b_np = numpy_params(cfg, seed), numpy_batch(cfg, seed=seed)
    params = transformer_params_from_numpy(cfg, p_np, device="cpu")
    batch = {k: torch.from_numpy(np.asarray(v, np.float32) if v.dtype != np.int32 else v)
             .to(torch.int32 if v.dtype == np.int32 else cfg.tdtype) for k, v in b_np.items()}
    return (params, batch), (jax.tree.map(jnp.asarray, p_np),
                             {k: jnp.asarray(v) for k, v in b_np.items()})


def _port_grads(params, cfg, batch):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    loss, metrics = T.loss_fn(tree_map(lambda _: next(it), params), cfg, batch, chunk=CHUNK)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, metrics, [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def _pairs(tree, jtree, path=()):
    """(path, port leaf, reference leaf) over the port's nest, the
    reference's dict indexed by the same keys."""
    if isinstance(tree, dict):
        assert set(tree) == set(jtree), path
        for k in tree:
            yield from _pairs(tree[k], jtree[k], path + (k,))
    else:
        yield path, tree, jtree


def _gap(got, want) -> float:
    """max |got - want| over max |want| (0 where both are 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    top = np.abs(want).max()
    return float(np.abs(got - want).max() / top) if top else float(np.abs(got).max())


# the MoE and hybrid archs run in tests/test_torch_train_moe.py
MOE_ARCHS = ("deepseek-moe-16b", "jamba-v0.1-52b", "qwen3-moe-235b-a22b")


@pytest.mark.parametrize("arch", [a for a in sorted(ARCHS) if a not in MOE_ARCHS])
def test_loss_and_gradients_equal_the_reference(arch, monkeypatch):
    check_loss_and_gradients(arch, monkeypatch)


def check_loss_and_gradients(arch, monkeypatch):
    """The loss and every gradient of reduced f32 ``arch`` against the
    reference's, and each MoE layer's routing (see the module docstring)."""
    jcfg, cfg = _cfgs(arch)
    (params, batch), (jparams, jbatch) = _both(cfg, jcfg)
    # each MoE layer's routing, recorded as the port computes it
    routes = []
    route = M.route

    def recording(xg, router, m):
        r = route(xg, router, m)
        routes.append((xg.detach().clone(), router.detach(), m, r.experts.clone(),
                       r.slot.clone()))
        return r
    monkeypatch.setattr(M, "route", recording)
    loss, metrics, grads = _port_grads(params, cfg, batch)
    it = iter(grads)
    grads = tree_map(lambda _: next(it), params)
    loss = loss.detach()

    def lf(p):
        return JT.loss_fn(p, jcfg, jbatch, chunk=CHUNK)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(lf, has_aux=True))(jparams)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    ce, aux = float(metrics["ce"].detach()), float(metrics["aux"].detach())
    assert abs(ce - float(jmetrics["ce"])) <= 1e-5 * float(jmetrics["ce"])
    assert abs(aux - float(jmetrics["aux"])) <= 1e-5 * max(1.0, abs(float(jmetrics["aux"])))
    pairs = {path: (g.numpy(), np.asarray(w)) for path, g, w in _pairs(grads, jgrads)}
    assert len(pairs) == len(jax.tree.leaves(jgrads))
    gaps = {}
    for path, (g, w) in pairs.items():
        top = np.abs(w).max()
        if path[-1] == "bk":
            # softmax ignores a shift common to a query's scores, so a key
            # bias has a zero gradient in exact arithmetic: rounding noise
            # on both sides, held at the scale of its wk's gradient
            top = max(top, np.abs(pairs[path[:-1] + ("wk",)][1]).max())
        err = float(np.abs(g.astype(np.float64) - w).max())
        gaps[path] = err / top if top else err                  # both 0: err is |g|
    bar = GRAD_BAR_HYBRID if cfg.family == "hybrid" else GRAD_BAR
    assert max(gaps.values()) <= bar, max(gaps.items(), key=lambda kv: kv[1])
    if cfg.moe is None:
        assert not routes
        return
    # the forward, then each group recomputed in the backward (last group
    # first): every recomputed layer meets its input bit for bit and routes
    # it identically
    n = len(routes) // 2
    assert n > 0 and len(routes) == 2 * n
    for x0, _, _, e0, s0 in routes[:n]:
        again = [r for r in routes[n:] if r[0].shape == x0.shape and torch.equal(r[0], x0)]
        assert len(again) == 1
        assert torch.equal(again[0][3], e0) and torch.equal(again[0][4], s0)
    for xg, router, m, experts, _ in routes[:n]:
        probs = jax.nn.softmax(jnp.asarray(xg.numpy()) @ jnp.asarray(router.numpy()), axis=-1)
        _, idx = jax.lax.top_k(probs, m.top_k)
        np.testing.assert_array_equal(experts.numpy(), np.asarray(idx))


def test_checkpointed_forward_equals_the_plain_one():
    """Grad mode on (each group recomputed in the backward) and off give
    the same bits, for a family of each kind of mixer and the encoder."""
    for arch in ("llama3.2-3b", "rwkv6-1.6b", "jamba-v0.1-52b", "whisper-tiny",
                 "deepseek-moe-16b"):
        jcfg, cfg = _cfgs(arch)
        (params, batch), _ = _both(cfg, jcfg)
        with torch.no_grad():
            plain = T.forward(params, cfg, batch)
            plain_loss = T.loss_fn(params, cfg, batch, chunk=CHUNK)[0]
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        out = T.forward(live, cfg, batch)
        assert out["x"].grad_fn is not None
        assert torch.equal(out["x"].detach(), plain["x"]), arch
        assert torch.equal(out["aux"].detach(), plain["aux"]), arch
        assert torch.equal(T.loss_fn(live, cfg, batch, chunk=CHUNK)[0].detach(), plain_loss)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_one_train_step_in_bf16(arch):
    """Twin of tests/test_models_smoke.py::test_one_train_step: the reduced
    bf16 model from the port's own init, one AdamW step at lr 1e-3: the
    loss and the gradients finite and nonzero, no explosion."""
    cfg = reduced(get_config(arch))
    assert cfg.dtype == "bfloat16"
    params = T.init_params(0, cfg, device="cpu")
    b_np = numpy_batch(cfg)
    batch = {k: torch.from_numpy(np.asarray(v, np.float32) if v.dtype != np.int32 else v)
             .to(torch.int32 if v.dtype == np.int32 else cfg.tdtype) for k, v in b_np.items()}
    oc = O.OptConfig(lr=1e-3)
    l0, _, grads = _port_grads(params, cfg, batch)
    gn = sum(float(g.float().abs().sum()) for g in grads)
    assert np.isfinite(float(l0.detach())) and np.isfinite(gn) and gn > 0
    state = O.adamw_init(params, oc)
    it = iter(grads)
    params, _ = O.adamw_update(params, tree_map(lambda _: next(it), params), state, oc)
    with torch.no_grad():
        l1 = T.loss_fn(params, cfg, batch, chunk=CHUNK)[0]
    assert np.isfinite(float(l1)) and float(l1) < float(l0) + 1.0
