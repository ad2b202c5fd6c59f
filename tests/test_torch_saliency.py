"""The port's Grad-CAM split-point search (``core/saliency.py``) and the
candidate ranking (``api/types.py``, ``core/qos.py``) against the JAX
package, with the same weights and inputs: the small VGG of
``tests/conftest.py`` (``vgg_cifar(8, 16, 0.25)``, its weights drawn with
numpy in the reference's tree as its init draws them) and a reduced
llama3.2-3b layered view.  The reference's maps run under ``jax.jit``: one
compile a model, where run op by op each primitive compiles on its own.

Bars, fixed before measuring: each saliency map within 1e-5 of max |map|
and the normalised CS curve within 1e-5 (f32 sums in other orders, far
below the curve's smallest step); the upsampling within 1e-6 of max |map|
(ROADMAP A8 measured 4.8e-7); maxima, candidates and rankings identical.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import types as JTY  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import qos as JQ  # noqa: E402
from repro.core import saliency as JSAL  # noqa: E402
from repro.data.synthetic import toy_images  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import reduced as jreduced  # noqa: E402
from repro.models.layered import transformer_as_layered as j_layered  # noqa: E402
from repro.models import vgg as jvgg  # noqa: E402
from repro.models.vgg import feature_index  # noqa: E402
from repro_torch.api import types as TTY  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import qos as TQ  # noqa: E402
from repro_torch.core import saliency as TSAL  # noqa: E402
from repro_torch.models import vgg as tvgg  # noqa: E402
from repro_torch.models.common import reduced  # noqa: E402
from repro_torch.models.layered import transformer_as_layered  # noqa: E402
from repro_torch.params import transformer_params_from_numpy, vgg_params_from_numpy  # noqa: E402

MAP_RTOL = 1e-5
CS_ATOL = 1e-5
RESIZE_RTOL = 1e-6



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


@functools.lru_cache(maxsize=None)
def _vgg_case():
    jm = jvgg.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
    jp = he_normal_like(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 0)
    tm = tvgg.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
    tp = vgg_params_from_numpy(tm, jax.tree.map(np.asarray, jp), device="cpu")

    def batch(seed, n=16):
        x, y = toy_images(n, hw=16, seed=seed)
        return (jnp.asarray(x), jnp.asarray(y)), (torch.from_numpy(x), torch.from_numpy(y))
    return jm, jp, tm, tp, feature_index(jm), batch


def normal_like(shapes, seed):
    """Weights for a reference transformer's params tree of
    ``ShapeDtypeStruct``s, drawn with numpy without compiling a JAX init:
    0.02 x normal, a norm's scale 1 + that."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        w = 0.02 * rng.standard_normal(s.shape)
        if "norm" in jax.tree_util.keystr(path) and path[-1].key == "w":
            w += 1.0
        return jnp.asarray(w.astype(s.dtype))
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _llama_case():
    cfg = dataclasses.replace(reduced(get_config("llama3.2-3b")), dtype="float32")
    jcfg = dataclasses.replace(jreduced(jget_config("llama3.2-3b")), dtype="float32")
    jparams = normal_like(jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(1), jcfg)), 1)
    tparams = transformer_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                            device="cpu")
    jm, tm = j_layered(jcfg, jparams), transformer_as_layered(cfg, tparams)

    def batch(seed, n=4):
        rng = np.random.default_rng(seed)
        toks, labels = (rng.integers(0, cfg.vocab, (n, 16)).astype(np.int32) for _ in range(2))
        return (({"tokens": jnp.asarray(toks)}, jnp.asarray(labels)),
                ({"tokens": torch.from_numpy(toks)}, torch.from_numpy(labels)))
    return (jm, jm.init(jax.random.PRNGKey(0)), tm, [{} for _ in tm.layers],
            list(range(1, len(tm.layers) - 1)), batch)


@pytest.fixture(scope="module", autouse=True)
def jitted_reference_maps():
    """``JSAL.layer_saliency_maps`` under ``jax.jit``, a compile for each
    model, for the reference's own ``cumulative_saliency`` and
    ``batched_cs`` too."""
    plain, compiled = JSAL.layer_saliency_maps, {}

    def maps(model, params, x, labels):
        if id(model) not in compiled:
            compiled[id(model)] = (model, jax.jit(lambda p, x, y: plain(model, p, x, y)))
        return compiled[id(model)][1](params, x, labels)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSAL, "layer_saliency_maps", maps)
        yield


@pytest.fixture(scope="module", params=["vgg_small", "llama3.2-3b"])
def case(request):
    """(JAX model, JAX params, port model, port params, layer_idx, batch(seed))."""
    return _vgg_case() if request.param == "vgg_small" else _llama_case()


def test_saliency_maps_match_the_reference(case):
    jm, jp, tm, tp, _, batch = case
    (jx, jy), (tx, ty) = batch(0)
    want = JSAL.layer_saliency_maps(jm, jp, jx, jy)
    got = TSAL.layer_saliency_maps(tm, tp, tx, ty)
    assert len(got) == len(want) == len(tm.layers)
    for layer, g, w in zip(tm.layers, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, layer.name
        assert np.abs(g.numpy() - w).max() <= MAP_RTOL * np.abs(w).max(), layer.name


def test_apply_with_taps_matches_the_reference(case):
    """The forward with a tap added to each layer's output, as the
    reference's (jitted); zero taps leave the port's forward as it was."""
    jm, jp, tm, tp, _, batch = case
    (jx, _), (tx, _) = batch(0)
    logits, acts = tm.apply_capture(tp, tx)
    rng = np.random.default_rng(3)
    taps = [(0.1 * rng.standard_normal(tuple(a.shape))).astype(np.float32) for a in acts]
    want = np.asarray(jax.jit(jm.apply_with_taps)(jp, jx, [jnp.asarray(t) for t in taps]))
    got = tm.apply_with_taps(tp, tx, [torch.from_numpy(t) for t in taps]).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= MAP_RTOL * np.abs(want).max()
    assert torch.equal(tm.apply_with_taps(tp, tx, [torch.zeros_like(a) for a in acts]), logits)


@functools.lru_cache(maxsize=None)
def _vgg_curves(seed):
    """The reference's and the port's CS curves of the small VGG on toy
    batch ``seed``, each computed once in the module."""
    jm, jp, tm, tp, idx, batch = _vgg_case()
    (jx, jy), (tx, ty) = batch(seed)
    return (JSAL.cumulative_saliency(jm, jp, jx, jy, layer_idx=idx),
            TSAL.cumulative_saliency(tm, tp, tx, ty, layer_idx=idx))


def test_cs_curve_matches_the_reference(case):
    jm, jp, tm, tp, idx, batch = case
    (jx, jy), (tx, ty) = batch(0)
    if tm.name == "vgg_cifar":
        want, got = _vgg_curves(0)
    else:
        want = JSAL.cumulative_saliency(jm, jp, jx, jy, layer_idx=idx)
        got = TSAL.cumulative_saliency(tm, tp, tx, ty, layer_idx=idx)
    assert got.dtype == np.float64 and got.shape == (len(idx),)
    np.testing.assert_allclose(got, want, rtol=0, atol=CS_ATOL)


def test_batched_cs_matches_the_reference(case):
    jm, jp, tm, tp, idx, batch = case
    want = JSAL.batched_cs(jm, jp, (batch(s)[0] for s in (1, 2)), 2, idx)
    got = TSAL.batched_cs(tm, tp, (batch(s)[1] for s in (1, 2)), 2, idx)
    np.testing.assert_allclose(got, want, rtol=0, atol=CS_ATOL)


def test_parameters_get_no_gradient_and_stay_as_they_are():
    """The backward pass reaches the taps only."""
    _, _, tm, tp, idx, batch = _vgg_case()
    before = [{k: v.clone() for k, v in p.items()} for p in tp]
    TSAL.cumulative_saliency(tm, tp, *batch(0)[1], layer_idx=idx)
    for p, q in zip(tp, before):
        for k in p:
            assert p[k].grad is None and not p[k].requires_grad and torch.equal(p[k], q[k])


# the reference's own plateau cases (tests/test_saliency.py) and curves with
# interior peaks, plateaus at a peak and at the ends
CURVES = [([0., 1., 0., 2., 2., 2., 1., 3., 0.], 1e-6), ([3., 2., 1.], 1e-9),
          ([0., 1., 2.], 1e-9),
          ([0.1, 0.5, 0.3, 0.3, 0.9, 0.9, 0.2, 0.6, 1.0], 1e-9),
          ([1.0, 0.2, 0.7, 0.7, 0.7, 0.1, 0.4, 0.35, 0.0], 1e-9),
          ([0.0, 0.0, 0.5, 0.5, 0.2, 0.8, 0.8, 0.8, 1.0], 1e-9)]


@pytest.mark.parametrize("curve,tol", CURVES)
def test_local_maxima_and_candidates_are_identical(curve, tol):
    jm, _, tm, _, idx, _ = _vgg_case()
    curve = np.array(curve)
    assert TSAL.local_maxima(curve, tol=tol) == JSAL.local_maxima(curve, tol=tol)
    if len(curve) == len(idx):
        for top_n in (1, 2, 5):
            assert (TSAL.candidate_split_points(tm, curve, idx, top_n)
                    == JSAL.candidate_split_points(jm, curve, idx, top_n))


def _ranking(sal, types, qos, model, cs, idx, top_n=3):
    """``Study.candidates``'s steps (repro/api/study.py:330-336): the CS
    maxima, else the legal cuts with the highest CS, ranked by ``qos``."""
    points = sal.candidate_split_points(model, cs, idx, top_n=top_n)
    if not points:
        ranked = sorted(types.legal_split_candidates(model, cs, idx),
                        key=lambda c: -c.accuracy_proxy)
        points = [c.split_layer for c in ranked[:top_n]]
    cands = qos.rank_candidates(cs, idx, points)
    return [(c.label, c.split_layer, c.accuracy_proxy, c.splits) for c in cands]


# the small VGG's curves on two batches of 16 toy images: batch 1's has no
# interior peak (asserted on both sides), batch 0's one at its index 1
PEAK_FREE_BATCH, PEAKED_BATCH = 1, 0


def test_fallback_ranking_is_identical_on_the_monotone_curve():
    """Where the reference's curve has no interior peak, both fall back to
    the highest-CS legal cuts; the port's curve ranks the same."""
    jm, jp, tm, tp, idx, batch = _vgg_case()
    jcs, tcs = _vgg_curves(PEAK_FREE_BATCH)
    assert JSAL.local_maxima(jcs) == [] == TSAL.local_maxima(tcs)
    want = _ranking(JSAL, JTY, JQ, jm, jcs, idx)
    got = _ranking(TSAL, TTY, TQ, tm, tcs, idx)
    assert [c[:2] for c in got] == [c[:2] for c in want]
    np.testing.assert_allclose([c[2] for c in got], [c[2] for c in want], rtol=0, atol=CS_ATOL)
    # on one curve, the two rank bit for bit, with and without peaks
    for cs in (jcs, np.array(CURVES[3][0])):
        assert _ranking(TSAL, TTY, TQ, tm, cs, idx) == _ranking(JSAL, JTY, JQ, jm, cs, idx)


def test_peak_ranking_is_identical_on_a_curve_with_a_peak():
    """Where the reference's curve has an interior peak, both rank from
    the peaks."""
    jm, jp, tm, tp, idx, batch = _vgg_case()
    jcs, tcs = _vgg_curves(PEAKED_BATCH)
    assert TSAL.local_maxima(tcs) == JSAL.local_maxima(jcs) != []
    want = _ranking(JSAL, JTY, JQ, jm, jcs, idx)
    got = _ranking(TSAL, TTY, TQ, tm, tcs, idx)
    assert [c[:2] for c in got] == [c[:2] for c in want]
    np.testing.assert_allclose([c[2] for c in got], [c[2] for c in want], rtol=0, atol=CS_ATOL)


# (source grid, target grid): ROADMAP A8's upsamplings, a 1-D map (linear),
# a map with no spatial dims (broadcast) and one already on the grid
RESIZES = [((7, 7), (14, 14)), ((14, 14), (224, 224)), ((28, 28), (224, 224)),
           ((112, 112), (224, 224)), ((1, 1), (224, 224)), ((3, 3), (32, 32)),
           ((5,), (17,)), ((), (16, 16)), ((16, 16), (16, 16))]


def _resize_input(src):
    return (1.5 * np.random.default_rng(len(src) + sum(src)).standard_normal((3,) + src)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def jax_resized():
    """The reference's ``_resize_to`` of every case, in one jitted call:
    one compile for the module, where run op by op each case compiles its
    primitives anew."""
    fn = jax.jit(lambda ms: [JSAL._resize_to(m, dst) for m, (_, dst) in zip(ms, RESIZES)])
    out = fn([jnp.asarray(_resize_input(src)) for src, _ in RESIZES])
    return {case: np.asarray(o) for case, o in zip(RESIZES, out)}


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_matches_jax_image_resize(src, dst, jax_resized):
    m = _resize_input(src)
    want = jax_resized[(src, dst)]
    got = TSAL._resize_to(torch.from_numpy(m), dst).numpy()
    assert got.shape == want.shape == (3,) + dst
    assert np.abs(got - want).max() <= RESIZE_RTOL * np.abs(want).max()


def test_resize_refuses_to_shrink():
    with pytest.raises(ValueError, match="never shrunk"):
        TSAL._resize_to(torch.zeros((2, 8, 8)), (4, 4))
