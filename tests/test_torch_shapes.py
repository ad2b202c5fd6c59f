"""The port's ``configs/shapes.py`` and ``training/train.train_state_struct``
against the JAX package's: for every arch of the registry and each of the
four shapes, ``SHAPES`` and ``variant_for_shape`` equal, and the abstract
inputs (``batch_struct``, ``input_specs``), parameters (``params_struct``)
and train state (``train_state_struct`` with bf16 moments and an f32 master
copy) equal to the reference's ``ShapeDtypeStruct``s in tree, shape and
dtype.  The port's stand-ins are ``meta`` tensors.

The reference's abstract init traces every group and every expert:
qwen3-moe-235b-a22b's 94 layers of 128 experts take about a minute,
deepseek-moe-16b's 28 of 64 about 10 s.  Their reference structs are
therefore taken at two layers, against the port's at two layers, and the
port's full-depth tree is held to the same with the group axis at full
depth.  58 s in the driver's 6-worker run with deepseek whole; less since.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS, get_config as jget_config  # noqa: E402
from repro.configs import shapes as JS  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train as JTR  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import shapes as S  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training import train as TR  # noqa: E402

# the MoE configs whose reference structs are taken at two layers
CUT = ("qwen3-moe-235b-a22b", "deepseek-moe-16b")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, path=()) -> dict:
    """{path: (shape, dtype name)} of a nest of ShapeDtypeStructs or tensors."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _flat(tree[k], path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree) for p, v in _flat(t, path + (i,)).items()}
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta", path
        return {path: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    return {path: (tuple(tree.shape), str(tree.dtype))}


def _configs(arch):
    """(reference cfg, port cfg), the CUT configs at two layers."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    if arch in CUT:
        jcfg, cfg = (dataclasses.replace(c, n_layers=2) for c in (jcfg, cfg))
    return jcfg, cfg


def test_shapes_and_window_equal_the_reference():
    assert S.SHAPES.keys() == JS.SHAPES.keys()
    for name, shape in S.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(JS.SHAPES[name])
    assert S.LONG_CONTEXT_WINDOW == JS.LONG_CONTEXT_WINDOW
    for arch in ARCHS:
        for name in S.SHAPES:
            got = S.variant_for_shape(get_config(arch), S.SHAPES[name])
            want = JS.variant_for_shape(jget_config(arch), JS.SHAPES[name])
            assert got.sliding_window == want.sliding_window, (arch, name)
            assert S.text_len(got, 4096) == JS.text_len(want, 4096)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_input_specs_equal_the_reference(arch):
    jcfg, cfg = _configs(arch)
    for name in S.SHAPES:
        got = S.input_specs(cfg, S.SHAPES[name])
        want = JS.input_specs(jcfg, JS.SHAPES[name])
        assert _flat(got) == _flat(want), (arch, name)
        for labels in (True, False):
            assert _flat(S.batch_struct(cfg, S.SHAPES[name], with_labels=labels)) == _flat(
                JS.batch_struct(jcfg, JS.SHAPES[name], with_labels=labels))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_and_train_state_structs_equal_the_reference(arch):
    jcfg, cfg = _configs(arch)
    opt = dict(moment_dtype="bfloat16", master_fp32=True)
    want = JTR.train_state_struct(jcfg, JO.OptConfig(**opt))
    got = TR.train_state_struct(cfg, O.OptConfig(**opt))
    assert _flat(got) == _flat(want)
    # the reference's train_state_struct traces its params_struct's init
    assert _flat(S.params_struct(cfg)) == _flat(want[0])
    # the default OptConfig: f32 moments, no master copy
    assert _flat(TR.train_state_struct(cfg, O.OptConfig())) == _flat(
        jax.eval_shape(lambda p: (p, JO.adamw_init(p, JO.OptConfig())), want[0]))
    if arch in CUT:
        full = S.params_struct(get_config(arch))
        n = get_config(arch).n_layers
        assert _flat(full) == {p: ((n,) + s[1:] if p[0] == "layers" else s, dt)
                               for p, (s, dt) in _flat(want[0]).items()}
