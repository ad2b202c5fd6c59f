"""The port's training half (``training/optimizer.py``, the losses and the
two training stages of ``core/bottleneck.py``) and its copy of
``data/synthetic.py`` against the JAX package, on the small VGG of
``tests/conftest.py`` (``vgg_cifar(8, 16, 0.25)``, its weights drawn with
numpy in the reference's tree), from the same weights, AEs and batches.

Bars, fixed before measuring: one Adam update within 1e-6 of max |param|
(the same f32 operations in the same order); the losses within 1e-6
relative; ``train_bottleneck``'s 5 losses and final AE within 1e-5
relative and ``finetune``'s 3 within 1e-4 (steps compound the sum-order
differences of the convolutions' backward passes); the data bit for bit.
The reference's functions run under ``jax.jit``, as its training loops run
them: one compile each, where run op by op each primitive compiles.
"""
import importlib.util
import itertools
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bottleneck as JB  # noqa: E402
from repro.data import synthetic as JD  # noqa: E402
from repro.models import vgg as jvgg  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch.core import bottleneck as TB  # noqa: E402
from repro_torch.data import synthetic as TD  # noqa: E402
from repro_torch.models import vgg as tvgg  # noqa: E402
from repro_torch.params import ae_from_numpy, vgg_params_from_numpy  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ADAM_RTOL = 1e-6
LOSS_RTOL = 1e-6
TRAIN_RTOL = 1e-5
FINETUNE_RTOL = 1e-4
SPLITS = [3, 6]          # relu3 and pool6 of the small VGG: (8, 8, 8) and (4, 4, 16)



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module: its tensors are
    small, and the tier-1 run keeps six test processes busy on the host's
    cores at once, where an op's thread pool mostly waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def he_normal_like(shapes, seed):
    """Weights for a reference params tree of ``ShapeDtypeStruct``s, drawn
    with numpy, without compiling a JAX init: normal with std
    sqrt(2 / fan-in), as the reference's VGG draws its convolutions, and
    biases 0."""
    rng = np.random.default_rng(seed)

    def draw(s):
        if len(s.shape) < 2:
            return jnp.zeros(s.shape, s.dtype)
        std = np.sqrt(2.0 / np.prod(s.shape[:-1]))
        return jnp.asarray((std * rng.standard_normal(s.shape)).astype(s.dtype))
    return jax.tree.map(draw, shapes)


@pytest.fixture(scope="module")
def pair():
    jm = jvgg.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
    jp = he_normal_like(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 0)
    tm = tvgg.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
    return jm, jp, tm, vgg_params_from_numpy(tm, jax.tree.map(np.asarray, jp), device="cpu")


_REF_AES = {}


def _ref_ae(jm, jp, split, seed=0, rate=0.5):
    """The AE the reference's ``train_bottleneck`` starts from: sized by the
    first batch of its iterator, drawn from ``PRNGKey(seed)``; drawn once a
    module for each model and cut (its draw compiles op by op)."""
    key = (id(jp), split, seed, rate)
    if key not in _REF_AES:
        x0, _ = next(JD.toy_image_iter(8, hw=16, seed=0))
        f0 = jax.eval_shape(lambda x: jm.apply_range(jp, x, 0, split + 1), jnp.asarray(x0))
        _REF_AES[key] = JB.init_bottleneck(jax.random.PRNGKey(seed), f0.shape[1:], rate)
    return _REF_AES[key]


def _close(got, want, rtol, what):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= rtol * np.abs(want).max(), what


def _check_ae(got, want, rtol):
    for part in ("enc", "dec"):
        for k in ("w", "b"):
            _close(got[part][k].numpy(), want[part][k], rtol, f"{part}.{k}")


def test_adam_updates_match_the_reference():
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": [(7,), (2, 2, 3)]}
    p = {"a": rng.standard_normal(shapes["a"]).astype(np.float32),
         "b": [rng.standard_normal(s).astype(np.float32) for s in shapes["b"]]}
    jp, tp = jax.tree.map(jnp.asarray, p), tree_map(torch.from_numpy, p)
    jst, tst = JO.adam_init(jp), TO.adam_init(tp)
    for step in range(3):           # gradients from large to below eps
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 10.0 ** (1 - 4 * step))
                         .astype(np.float32), p)
        jp, jst = jax.jit(JO.adam_update)(jp, jax.tree.map(jnp.asarray, g), jst, 5e-4)
        tp, tst = TO.adam_update(tp, tree_map(torch.from_numpy, g), tst, 5e-4)
        assert int(tst["t"]) == int(jst["t"]) == step + 1
        for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            _close(got.numpy(), want, ADAM_RTOL, f"step {step}")
        for key in ("m", "v"):
            for got, want in zip(tree_leaves(tst[key]), jax.tree.leaves(jst[key])):
                _close(got.numpy(), want, ADAM_RTOL, f"{key} step {step}")


def test_ae_loss_matches_the_reference(pair):
    jm, jp, _, _ = pair
    jae = _ref_ae(jm, jp, 6)
    feats = np.random.default_rng(1).standard_normal((8, 4, 4, 16)).astype(np.float32)
    loss, recon = jax.jit(lambda a, f: (JB.ae_loss(a, f), JB.reconstruct(a, f)))(
        jae, jnp.asarray(feats))
    want = float(loss)
    got = float(TB.ae_loss(ae_from_numpy(jax.tree.map(np.asarray, jae), device="cpu"),
                           torch.from_numpy(feats)))
    assert abs(got - want) <= LOSS_RTOL * abs(want)
    _close(TB.reconstruct(ae_from_numpy(jax.tree.map(np.asarray, jae), device="cpu"),
                          torch.from_numpy(feats)).numpy(), recon, LOSS_RTOL, "reconstruct")


@pytest.fixture(scope="module")
def ref_task_losses(pair):
    """The reference's ``task_loss`` of every case below on toy batch 3, in
    one jitted call: one compile, where a jit a case compiles four."""
    jm, jp, _, _ = pair
    jae = _ref_ae(jm, jp, 6)
    x, y = JD.toy_images(8, hw=16, seed=3)
    losses = jax.jit(lambda p, a, x, y: {
        (kind, with_ae): JB.task_loss(jm, p, a if with_ae else None, 6, x, y, kind)
        for kind in ("mse", "ce") for with_ae in (True, False)})(
        jp, jae, jnp.asarray(x), jnp.asarray(y))
    return {k: float(v) for k, v in losses.items()}


@pytest.mark.parametrize("kind", ["mse", "ce"])
@pytest.mark.parametrize("with_ae", [True, False])
def test_task_loss_matches_the_reference(pair, ref_task_losses, kind, with_ae):
    jm, jp, tm, tp = pair
    jae = _ref_ae(jm, jp, 6) if with_ae else None
    tae = ae_from_numpy(jax.tree.map(np.asarray, jae), device="cpu") if with_ae else None
    x, y = JD.toy_images(8, hw=16, seed=3)
    want = ref_task_losses[(kind, with_ae)]
    got = float(TB.task_loss(tm, tp, tae, 6, torch.from_numpy(x), torch.from_numpy(y), kind))
    assert abs(got - want) <= LOSS_RTOL * abs(want)


@pytest.mark.parametrize("split", SPLITS)
def test_train_bottleneck_matches_the_reference_from_its_init(pair, split):
    """The reference trains from its own AE; the port's loop starts from the
    same AE (carried over) and takes the same batches after the first."""
    jm, jp, tm, tp = pair
    jae, jlosses = JB.train_bottleneck(jm, jp, split, JD.toy_image_iter(8, hw=16, seed=0), 5)
    it = TD.toy_image_iter(8, hw=16, seed=0)
    next(it)                                    # the reference spent it on shapes
    ae0 = ae_from_numpy(jax.tree.map(np.asarray, _ref_ae(jm, jp, split)), device="cpu")
    tae, tlosses = TB.train_bottleneck_from(tm, tp, split, ae0, it, 5, device="cpu")
    np.testing.assert_allclose(tlosses, jlosses, rtol=TRAIN_RTOL, atol=0)
    _check_ae(tae, jae, TRAIN_RTOL)


def test_train_bottleneck_spends_its_first_batch_on_shapes(pair):
    _, _, tm, tp = pair
    ae, losses = TB.train_bottleneck(tm, tp, 6, TD.toy_image_iter(8, hw=16, seed=0), 3,
                                     seed=5, device="cpu")
    it = TD.toy_image_iter(8, hw=16, seed=0)
    next(it)
    ae0 = TB.init_bottleneck(5, (4, 4, 16), 0.5, device="cpu")
    want_ae, want = TB.train_bottleneck_from(tm, tp, 6, ae0, it, 3, device="cpu")
    assert losses == want
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ae), tree_leaves(want_ae)))


def test_finetune_matches_the_reference_from_its_state(pair):
    jm, jp, tm, tp = pair
    jae = _ref_ae(jm, jp, 6)
    tae = ae_from_numpy(jax.tree.map(np.asarray, jae), device="cpu")
    jparams, jae2, jlosses = JB.finetune(jm, jp, jae, 6, JD.toy_image_iter(8, hw=16, seed=7), 3)
    tparams, tae2, tlosses = TB.finetune(tm, tp, tae, 6, TD.toy_image_iter(8, hw=16, seed=7), 3,
                                         device="cpu")
    np.testing.assert_allclose(tlosses, jlosses, rtol=FINETUNE_RTOL, atol=0)
    want = vgg_params_from_numpy(tm, jax.tree.map(np.asarray, jparams), device="cpu")
    for layer, got_p, want_p in zip(tm.layers, tparams, want):
        for k in got_p:
            _close(got_p[k].numpy(), want_p[k].numpy(), FINETUNE_RTOL, f"{layer.name}.{k}")
    _check_ae(tae2, jae2, FINETUNE_RTOL)
    # the inputs stay as they were
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(tp), tree_leaves(vgg_params_from_numpy(
            tm, jax.tree.map(np.asarray, jp), device="cpu"))))


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("split", SPLITS)
def test_the_replay_branch_loss_is_the_task_loss(pair, ref_task_losses, chip_smoke, split):
    """``chip_smoke.branch_loss``, which Z12's finetune replay differentiates
    on the card's branch, is ``task_loss`` (mse, with an AE): on the branch
    it finds and on that branch given back, the same loss and gradient bit
    for bit, the reference's loss at LOSS_RTOL; ``branch_moves`` sees a
    ReLU sent the other way and a pool on another element, each at its
    distance from the CPU's choice over the layer's max |input|."""
    jm, jp, tm, tp = pair
    ae = ae_from_numpy(jax.tree.map(np.asarray, _ref_ae(jm, jp, split)), device="cpu")
    x, y = (torch.from_numpy(a) for a in JD.toy_images(8, hw=16, seed=3))
    state = {"params": tp, "ae": ae}
    found = []
    loss, g = TB.value_and_grad(lambda st: TB.task_loss(tm, st["params"], st["ae"], split, x, y),
                                state)
    for kw in ({"record": found}, {"branch": found}):
        got, got_g = TB.value_and_grad(
            lambda st: chip_smoke.branch_loss(tm, st, split, x, y, **kw), state)
        assert float(got) == float(loss)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got_g), tree_leaves(g)))
    if split == 6:
        want = ref_task_losses[("mse", True)]
        assert abs(float(loss) - want) <= LOSS_RTOL * abs(want)
    assert chip_smoke.branch_moves(found, found) == {"flips": 0, "moves": 0, "rel": 0.0}
    at_relu = next(i for i, r in enumerate(found) if r[0] == "relu")
    at_pool = next(i for i, r in enumerate(found) if r[0] == "pool")
    moved = list(found)
    _, mask, v = found[at_relu]
    i = int(v.abs().flatten().argmin())
    flipped = mask.clone().flatten()
    flipped[i] = ~flipped[i]
    moved[at_relu] = ("relu", flipped.view_as(mask), v)
    _, idx, pv = found[at_pool]
    other = idx.clone()
    other[0, 0, 0, 0] = idx[0, 0, 0, 0] ^ 1          # the window's other column
    moved[at_pool] = ("pool", other, pv)
    flat = pv.permute(0, 3, 1, 2).flatten(2)
    pool_rel = float((flat[0, 0, idx[0, 0, 0, 0]] - flat[0, 0, other[0, 0, 0, 0]]).abs()
                     / pv.abs().max())
    seen = chip_smoke.branch_moves(moved, found)
    assert (seen["flips"], seen["moves"]) == (1, 1)
    assert seen["rel"] == max(float(v.flatten()[i].abs() / v.abs().max()), pool_rel)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synthetic_data_is_bit_equal(seed):
    for got, want in zip(TD.toy_images(12, hw=16, seed=seed), JD.toy_images(12, hw=16, seed=seed)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for (gx, gy), (wx, wy) in zip(itertools.islice(TD.toy_image_iter(4, 224, seed), 2),
                                  itertools.islice(JD.toy_image_iter(4, 224, seed), 2)):
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
    got, want = TD.token_batch(3, 20, 512, seed), JD.token_batch(3, 20, 512, seed)
    assert all(np.array_equal(got[k], want[k]) for k in ("tokens", "labels"))
