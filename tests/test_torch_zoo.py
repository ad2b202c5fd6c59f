"""The port's transformer zoo (reduced llama3.2-3b, rwkv6-1.6b and
jamba-v0.1-52b with its dense FFN) on the CPU against the JAX package with
the same weights: forward, prefill + decode, the layered view, the serving
engine and the parameter crossing."""
import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import reduced as jreduced  # noqa: E402
from repro.models.layered import transformer_as_layered as j_layered  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import ARCHS, SERVED, get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import reduced  # noqa: E402
from repro_torch.models.layered import transformer_as_layered  # noqa: E402
from repro_torch.params import transformer_params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHES = ["llama3.2-3b", "rwkv6-1.6b"]
PAIR_ARCHES = ARCHES + ["jamba-v0.1-52b"]
# f32 logits: the two frameworks sum in other orders (1e-3, as
# tests/test_serving_consistency.py holds prefill + decode to forward)
TOL = 1e-3


def _pair(arch, dtype="float32", **overrides):
    overrides = {**SERVED.get(arch, {}), **overrides}
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype, **overrides)
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), dtype=dtype, **overrides)
    jp = JT.init_params(jax.random.PRNGKey(1), jcfg)
    tp = transformer_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jcfg, tp, jp


@pytest.fixture(scope="module", params=PAIR_ARCHES)
def pair(request):
    return _pair(request.param)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _logits(params, cfg, toks):
    out = T.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    return T.logits_from_x(params, cfg, out["x"]).float().numpy()


def _jlogits(params, cfg, toks):
    out = JT.forward(params, cfg, {"tokens": jnp.asarray(toks)})
    return np.asarray(JT.logits_from_x(params, cfg, out["x"]).astype(jnp.float32))


def test_forward_logits_match_reference(pair):
    cfg, jcfg, tp, jp = pair
    toks = _tokens(cfg, 2, 24, 3)
    np.testing.assert_allclose(_logits(tp, cfg, toks), _jlogits(jp, jcfg, toks),
                               rtol=TOL, atol=TOL)


def _check_prefill_decode(cfg, tp, gt, toks, n_prompt, cache_len):
    """prefill + serve_step reproduce ``gt``, the full forward's logits."""
    with torch.inference_mode():
        logits, cache, pos = T.prefill(tp, cfg, {"tokens": torch.from_numpy(toks[:, :n_prompt])},
                                       cache_len)
        assert pos == n_prompt
        np.testing.assert_allclose(logits.float().numpy(), gt[:, n_prompt - 1], rtol=TOL,
                                   atol=TOL)
        for i in range(n_prompt, toks.shape[1]):
            logits, cache = T.serve_step(tp, cfg, cache, torch.from_numpy(toks[:, i:i + 1]), i)
            np.testing.assert_allclose(logits.numpy(), gt[:, i], rtol=TOL, atol=TOL)


def test_prefill_then_decode_reproduces_the_reference_forward(pair):
    cfg, jcfg, tp, jp = pair
    toks = _tokens(cfg, 2, 24, 4)
    _check_prefill_decode(cfg, tp, _jlogits(jp, jcfg, toks), toks, 16, 64)


def test_sliding_window_decode_matches_windowed_reference_forward():
    cfg, jcfg, tp, jp = _pair("llama3.2-3b", sliding_window=8)
    toks = _tokens(cfg, 1, 24, 5)
    gt = _jlogits(jp, jcfg, toks)
    np.testing.assert_allclose(_logits(tp, cfg, toks), gt, rtol=TOL, atol=TOL)
    # an 8-slot ring buffer: decode wraps round it
    _check_prefill_decode(cfg, tp, gt, toks, 16, 24)


@pytest.mark.parametrize("arch", ARCHES)
def test_bf16_forward_stays_near_the_reference(arch):
    """bf16 weights and activations: the two frameworks round intermediates
    at other places (measured: 0.9% of max |logit| for llama, 2.9% for rwkv,
    whose decay exp(-exp(.)) magnifies them), so the bar is 5e-2 of max
    |logit| and the same argmax at 90% of positions."""
    cfg, jcfg, tp, jp = _pair(arch, dtype="bfloat16")
    assert tp["embed"].dtype == torch.bfloat16
    toks = _tokens(cfg, 2, 16, 6)
    got, want = _logits(tp, cfg, toks), _jlogits(jp, jcfg, toks)
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


def test_rwkv_bf16_prefill_then_decode_equal_the_bf16_forward():
    """In bf16, rwkv6's decode path computes what its forward computes: on
    the CPU, prefill + serve_step give the forward's logits bit for bit (4
    layers, the served head dim 64).  Where the two differ on the card, the
    card's libraries round a one-token product otherwise than a whole-prompt
    one.  (The dense family's decode attention is plain ops outside the
    kernel, summing in another order, so there the two may differ by a
    rounding.)"""
    cfg = dataclasses.replace(reduced(get_config("rwkv6-1.6b"), rwkv_head_dim=64),
                              dtype="bfloat16", n_layers=4)
    tp = T.init_params(0, cfg, device="cpu")
    toks = _tokens(cfg, 2, 40, 4)
    with torch.inference_mode():
        gt = T.logits_from_x(tp, cfg, T.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})["x"])
        logits, cache, _ = T.prefill(tp, cfg, {"tokens": torch.from_numpy(toks[:, :24])}, 64)
        steps = [logits]
        for i in range(24, 40):
            logits, cache = T.serve_step(tp, cfg, cache, torch.from_numpy(toks[:, i:i + 1]), i)
            steps.append(logits)
    got = torch.stack([x.float() for x in steps], 1)
    torch.testing.assert_close(got, gt[:, 23:].float(), rtol=0, atol=0)


def test_layered_view_matches_forward_and_reference_cuts(pair):
    cfg, jcfg, tp, jp = pair
    lay, jlay = transformer_as_layered(cfg, tp), j_layered(jcfg, jp)
    assert lay.cut_points() == jlay.cut_points()
    assert [l.name for l in lay.layers] == [l.name for l in jlay.layers]
    toks = _tokens(cfg, 2, 12, 8)
    got = lay.apply(lay.init(0, device="cpu"), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), _logits(tp, cfg, toks), rtol=1e-6, atol=1e-6)


def test_serving_engine_gives_the_reference_greedy_tokens(pair):
    cfg, jcfg, tp, jp = pair
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (5, 12, 9)]
    news = (6, 4, 6)
    got = ServingEngine(cfg, tp, cache_slots=32, device="cpu").run(
        [Request(i, p, max_new=m) for i, (p, m) in enumerate(zip(prompts, news))])
    want = JEngine(jcfg, jp, cache_slots=32).run(
        [JRequest(i, p, max_new=m) for i, (p, m) in enumerate(zip(prompts, news))])
    assert [r.out for r in got] == [r.out for r in want]
    assert [len(r.out) for r in got] == list(news)


def test_bf16_leaves_cross_bit_for_bit_and_mismatched_trees_raise():
    cfg, _, tp, jp = _pair("rwkv6-1.6b", dtype="bfloat16")
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    assert any(a.dtype == jnp.bfloat16 for _, a in leaves)
    for path, a in leaves:
        t = tp
        for key in path:
            t = t[key.key]
        a = np.asarray(a)
        bits = a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)
        got = t.view(torch.int16 if a.dtype.itemsize == 2 else torch.int32).numpy()
        np.testing.assert_array_equal(got, bits.view(got.dtype))
    params_np = jax.tree.map(np.asarray, jp)
    with pytest.raises(ValueError, match="want keys"):
        transformer_params_from_numpy(cfg, {k: v for k, v in params_np.items() if k != "head"},
                                      device="cpu")
    params_np["embed"] = params_np["embed"][:-1]
    with pytest.raises(ValueError, match="embed: want"):
        transformer_params_from_numpy(cfg, params_np, device="cpu")
    wider = dataclasses.replace(cfg, d_ff=cfg.d_ff * 2)
    with pytest.raises(ValueError, match="w_k: want"):
        transformer_params_from_numpy(wider, jax.tree.map(np.asarray, jp), device="cpu")


def test_config_registry_knows_the_ten_names():
    from repro.configs import ARCHS as JARCHS
    assert ARCHS == JARCHS
    items = {"moe": "A13b", "encdec": "A17", "vlm": "A17"}
    for name in ARCHS:
        jcfg = jget_config(name)
        if jcfg.family in ("dense", "ssm", "hybrid"):
            assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jcfg)
        else:
            with pytest.raises(NotImplementedError, match=f"ROADMAP {items[jcfg.family]}"):
                get_config(name)
    with pytest.raises(KeyError):
        get_config("gpt-5")


def test_unported_branches_raise():
    cfg = reduced(get_config("llama3.2-3b"))
    for family in ("vlm", "encdec"):
        with pytest.raises(NotImplementedError, match="ROADMAP A17"):
            T.init_params(0, dataclasses.replace(cfg, family=family), device="cpu")
    # jamba as configured: its MoE layers raise; with moe=None it builds
    jamba = reduced(get_config("jamba-v0.1-52b"))
    for build in (lambda c: T.init_params(0, c, device="cpu"), T.param_spec):
        with pytest.raises(NotImplementedError, match="MoE FFN.*ROADMAP A13b"):
            build(jamba)
    spec = T.param_spec(dataclasses.replace(jamba, moe=None))
    assert set(spec["layers"]) == {f"l{j}" for j in range(8)}
    assert "attn" in spec["layers"]["l4"] and "mamba" in spec["layers"]["l0"]


@pytest.mark.parametrize("name", ["init_params", "init_cache", "transformer_params_from_numpy",
                                  "ServingEngine"])
def test_entry_points_raise_without_cuda_unless_asked_for_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    cfg = dataclasses.replace(reduced(get_config("llama3.2-3b"), n_layers=1), dtype="float32")
    params_np = _numpy_tree(T.init_params(0, cfg, device="cpu"))
    calls = {
        "init_params": lambda **kw: T.init_params(0, cfg, **kw),
        "init_cache": lambda **kw: T.init_cache(cfg, 1, 8, **kw),
        "transformer_params_from_numpy": lambda **kw: transformer_params_from_numpy(
            cfg, params_np, **kw),
        "ServingEngine": lambda **kw: ServingEngine(cfg, {}, **kw),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[name]()
    calls[name](device="cpu")


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


def test_port_imports_nothing_of_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), f"{f.name} imports {n}"
