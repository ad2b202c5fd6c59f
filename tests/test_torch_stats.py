"""The port's Table I/II statistics (``core/stats.py``) and wire payloads
(``core/split.py``) against the JAX package: the small VGG of
``tests/conftest.py`` (the port's own weights: statistics read shapes only)
and full-width VGG16 without weights (the reference's shapes from
``jax.eval_shape`` of ``model.init`` on both, the port's VGG16 on the
``meta`` device), and reduced llama3.2-3b and rwkv6-1.6b layered views with
the same weights.  Every number is an integer count or a ratio of one, so
the bar is equality."""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import split as jsplit  # noqa: E402
from repro.core import stats as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import vgg as jvgg  # noqa: E402
from repro.models.common import reduced as jreduced  # noqa: E402
from repro.models.layered import transformer_as_layered as j_layered  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import split as tsplit  # noqa: E402
from repro_torch.core import stats as TS  # noqa: E402
from repro_torch.models import vgg as tvgg  # noqa: E402
from repro_torch.models.common import reduced  # noqa: E402
from repro_torch.models.layered import transformer_as_layered  # noqa: E402
from repro_torch.params import transformer_params_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CASES = ["vgg_small", "vgg16", "llama3.2-3b", "rwkv6-1.6b"]
VGG_CASES = CASES[:2]



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module: its tensors are
    small, and the tier-1 run keeps six test processes busy on the host's
    cores at once, where an op's thread pool mostly waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _shapes_memo(model):
    """``model.activation_shapes`` remembered on the instance by batch and
    sample shapes.  The payload checks ask each model for the same shapes
    once a cut, and each ask is a trace (the reference's
    ``jax.eval_shape``) or a forward (a view's sample); the shapes
    themselves are held equal by ``test_summary_rows_equal_the_reference``
    and ``test_transformer_views_count_what_the_reference_counts``."""
    plain, memo = model.activation_shapes, {}

    def shapes(params, batch=1, *, sample=None):
        key = (batch, None if sample is None else
               tuple((k, tuple(v.shape)) for k, v in sorted(sample.items())))
        if key not in memo:
            memo[key] = plain(params, batch, sample=sample)
        return memo[key]
    model.activation_shapes = shapes
    return model


@functools.lru_cache(maxsize=None)
def _vgg_small():
    """The small VGG: the reference's params as ``ShapeDtypeStruct``s, the
    port's from its own init."""
    jm = jvgg.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
    tm = tvgg.vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
    return (jm, jax.eval_shape(jm.init, jax.random.PRNGKey(0)), tm, tm.init(0, device="cpu"),
            {}, {})


@functools.lru_cache(maxsize=None)
def _vgg16():
    """Full VGG16 on both sides without weights: the reference's params as
    ``ShapeDtypeStruct``s, the port's as ``meta`` tensors (conv OIHW)."""
    jm, tm = jvgg.vgg16(), tvgg.vgg16()
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tp = []
    for layer, p in zip(jm.layers, jp):
        if layer.kind == "conv":
            kh, kw, cin, cout = p["w"].shape
            tp.append({"w": torch.empty((cout, cin, kh, kw), device="meta"),
                       "b": torch.empty(p["b"].shape, device="meta")})
        else:
            tp.append({k: torch.empty(v.shape, device="meta") for k, v in p.items()})
    return jm, jp, tm, tp, {}, {}


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


@functools.lru_cache(maxsize=None)
def _view(arch):
    """Reduced layered views with the same weights, and a token batch each
    side takes as its ``sample``."""
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), dtype="float32")
    jparams = normal_like(jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(1), jcfg)), 1)
    tparams = transformer_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                            device="cpu")
    jm, tm = j_layered(jcfg, jparams), transformer_as_layered(cfg, tparams)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    return (jm, jm.init(jax.random.PRNGKey(0)), tm, [{} for _ in tm.layers],
            {"sample": {"tokens": jnp.asarray(toks)}},
            {"sample": {"tokens": torch.from_numpy(toks)}})


@pytest.fixture(scope="module", params=CASES)
def case(request):
    """(JAX model, JAX params, port model, port params, JAX kwargs, port kwargs)."""
    jm, jp, tm, tp, jkw, tkw = {"vgg_small": _vgg_small, "vgg16": _vgg16}.get(
        request.param, functools.partial(_view, request.param))()
    return _shapes_memo(jm), jp, _shapes_memo(tm), tp, jkw, tkw


def _rows(rows):
    return [dataclasses.astuple(r) for r in rows]


def test_summary_rows_equal_the_reference(case):
    jm, jp, tm, tp, jkw, tkw = case
    for batch in (1, 16):
        want = JS.summary(jm, jp, batch, **jkw)
        got = TS.summary(tm, tp, batch, **tkw)
        assert _rows(got) == _rows(want)
        assert TS.format_table(got) == JS.format_table(want)
        assert TS.format_table(got, 3) == JS.format_table(want, 3)
    assert TS.summary(tm, tp, 16, **tkw) is got                 # cached on the model


def test_flops_equal_the_reference(case):
    jm, jp, tm, tp, jkw, tkw = case
    assert TS.total_flops(tm, tp, 2, **tkw) == JS.total_flops(jm, jp, 2, **jkw)
    np.testing.assert_array_equal(TS.flops_prefix(tm, tp, 2, **tkw),
                                  JS.flops_prefix(jm, jp, 2, **jkw))
    for cut in tm.cut_points():
        assert TS.flops_split(tm, tp, cut, 2, **tkw) == JS.flops_split(jm, jp, cut, 2, **jkw)
    for cuts in tsplit.legal_cut_lists(tm, 2)[::7]:
        assert TS.flops_stages(tm, tp, cuts, 2, **tkw) == JS.flops_stages(jm, jp, cuts, 2, **jkw)


def test_payload_bytes_equal_the_reference(case):
    jm, jp, tm, tp, jkw, tkw = case
    assert tsplit.legal_cuts(tm) == jsplit.legal_cuts(jm)
    for cut in tm.cut_points():
        got = tsplit.wire_payload_bytes(tm, tp, tsplit.SplitPlan(cut), 3, **tkw)
        assert got == jsplit.wire_payload_bytes(jm, jp, jsplit.SplitPlan(cut), 3, **jkw), cut
    for rate, wire in ((0.5, 4), (0.25, 1)):
        cuts = tsplit.legal_cut_lists(tm, 2)[-1]
        plan = dict(split_layer=None, compression=rate, wire_dtype_bytes=wire, splits=cuts)
        assert (tsplit.hop_payload_bytes(tm, tp, tsplit.SplitPlan(**plan), 3, **tkw)
                == jsplit.hop_payload_bytes(jm, jp, jsplit.SplitPlan(**plan), 3, **jkw))


@pytest.mark.parametrize("name", VGG_CASES)
def test_totals_equal_the_reference(name):
    jm, jp, tm, tp, _, _ = _vgg16() if name == "vgg16" else _vgg_small()
    for batch in (1, 16):
        assert TS.totals(tm, tp, batch) == JS.totals(jm, jp, batch)


def test_vgg16_table_ii_and_the_constants_chip_smoke_holds_it_to():
    """138,357,544 parameters (paper Table II), and the reference's totals
    at batch 16 that ``chip_smoke.py`` Z11 holds the card's Table II to
    (the card's machine has no JAX, so they are written into the script)."""
    jm, jp, tm, tp, _, _ = _vgg16()
    got = TS.totals(tm, tp, 16)
    assert got["total_params"] == 138_357_544
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.VGG16_TOTALS_16 == JS.totals(jm, jp, 16) == got


def test_transformer_views_count_what_the_reference_counts():
    """The three counters a view's layers carry (embed 0, a block its 2-D
    weights a token, the head d_model x vocab a token) and the plain
    Layer's default of none."""
    jm, jp, tm, tp, jkw, tkw = _view("llama3.2-3b")
    rows = TS.summary(tm, tp, **tkw)
    assert rows[0].mult_adds == 0 and all(r.mult_adds > 0 for r in rows[1:])
    assert all(l.mult_adds is None for l in tvgg.vgg16().layers)
    assert tm.activation_shapes(tp, **tkw) == [tuple(s) for s in jm.activation_shapes(jp, **jkw)]
