"""The port's transformer zoo (reduced llama3.2-3b, rwkv6-1.6b,
deepseek-moe-16b, and jamba-v0.1-52b with its dense FFN and with its MoE)
on the CPU against the JAX package with the same weights: forward, prefill
+ decode, the layered view, the serving engine and the parameter crossing.
Every MoE layer runs at the served capacity factor (the config's 1.25)."""
import ast
import dataclasses
import functools
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
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import reduced  # noqa: E402
from repro_torch.models.layered import transformer_as_layered  # noqa: E402
from repro_torch.params import transformer_params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHES = ["llama3.2-3b", "rwkv6-1.6b"]
# each pair: (arch, the changes to its config); jamba twice, as the card
# serves it (configs.SERVED: every FFN the dense SwiGLU) and with its MoE
PAIRS = {"llama3.2-3b": ("llama3.2-3b", {}), "rwkv6-1.6b": ("rwkv6-1.6b", {}),
         "jamba-v0.1-52b": ("jamba-v0.1-52b", SERVED["jamba-v0.1-52b"]),
         "deepseek-moe-16b": ("deepseek-moe-16b", {}),
         "jamba-v0.1-52b-moe": ("jamba-v0.1-52b", {})}
DENSE_PAIRS = ARCHES + ["jamba-v0.1-52b"]
MOE_PAIRS = ["deepseek-moe-16b", "jamba-v0.1-52b-moe"]
# f32 logits: the two frameworks sum in other orders (1e-3, as
# tests/test_serving_consistency.py holds prefill + decode to forward)
TOL = 1e-3


def _pair(name, dtype="float32", **overrides):
    arch, changes = PAIRS[name]
    overrides = {**changes, **overrides}
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype, **overrides)
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), dtype=dtype, **overrides)
    jp = JT.init_params(jax.random.PRNGKey(1), jcfg)
    tp = transformer_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jcfg, tp, jp


@functools.lru_cache(maxsize=None)
def _f32_pair(name):
    """The f32 pair of ``name``, built once a process for the fixtures below
    (no test writes into its parameters)."""
    return _pair(name)


@pytest.fixture(scope="module", params=list(PAIRS))
def pair(request):
    return _f32_pair(request.param)


@pytest.fixture(scope="module", params=DENSE_PAIRS)
def dense_pair(request):
    return _f32_pair(request.param)


@pytest.fixture(scope="module", params=MOE_PAIRS)
def moe_pair(request):
    return _f32_pair(request.param)


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


def test_prefill_then_decode_reproduces_the_reference_forward(dense_pair):
    cfg, jcfg, tp, jp = dense_pair
    toks = _tokens(cfg, 2, 24, 4)
    _check_prefill_decode(cfg, tp, _jlogits(jp, jcfg, toks), toks, 16, 64)


def test_moe_prefill_then_decode_equal_the_reference_prefill_and_serve_step(moe_pair):
    """An MoE model's decode cannot reproduce its forward: the prefill routes
    the prompt in groups of the prompt's length, where a full forward would
    group prompt and decoded tokens together (other capacities, other
    drops), and each decode step is a group of one.  So prefill + decode is
    held against the reference's own ``prefill`` + ``serve_step``."""
    cfg, jcfg, tp, jp = moe_pair
    toks = _tokens(cfg, 2, 24, 4)
    n_prompt, cache_len = 16, 64
    with torch.inference_mode():
        logits, cache, pos = T.prefill(tp, cfg, {"tokens": torch.from_numpy(toks[:, :n_prompt])},
                                       cache_len)
        # the reference under jax.jit, as its engine runs it (op by op each
        # primitive compiles on its own)
        jprefill = jax.jit(JT.prefill, static_argnums=(1, 3))
        jstep = jax.jit(JT.serve_step, static_argnums=(1,))
        jlogits, jcache, jpos = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :n_prompt])},
                                         cache_len)
        assert pos == int(jpos) == n_prompt
        np.testing.assert_allclose(logits.float().numpy(), np.asarray(jlogits, np.float32),
                                   rtol=TOL, atol=TOL)
        for i in range(n_prompt, toks.shape[1]):
            logits, cache = T.serve_step(tp, cfg, cache, torch.from_numpy(toks[:, i:i + 1]), i)
            jlogits, jcache = jstep(jp, jcfg, jcache, jnp.asarray(toks[:, i:i + 1]),
                                    jnp.asarray(i, jnp.int32))
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=TOL, atol=TOL)


def _counting_drops(monkeypatch):
    """Count, layer by layer, the pairs each ``moe_ffn`` call drops."""
    drops, plain = [], M.moe_ffn

    def counted(x, p, m, **kw):
        drops.append(int(M.dropped_pairs(x, p, m, **kw)))
        return plain(x, p, m, **kw)
    monkeypatch.setattr(M, "moe_ffn", counted)
    return drops


def test_moe_pairs_drop_at_the_served_capacity(moe_pair, monkeypatch):
    """The forward tests' prompts overflow an expert in at least one MoE
    layer, so the drop path is held against the reference; a decode step,
    one token a group, drops nothing."""
    cfg, _, tp, _ = moe_pair
    drops = _counting_drops(monkeypatch)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    with torch.inference_mode():
        _, cache, pos = T.prefill(tp, cfg, {"tokens": torch.from_numpy(_tokens(cfg, 2, 24, 3))},
                                  32)
        assert len(drops) == n_moe and sum(drops) > 0, drops
        drops.clear()
        T.serve_step(tp, cfg, cache, torch.from_numpy(_tokens(cfg, 2, 1, 5)), pos)
    assert len(drops) == n_moe and sum(drops) == 0


def test_sliding_window_decode_matches_windowed_reference_forward():
    cfg, jcfg, tp, jp = _pair("llama3.2-3b", sliding_window=8)
    toks = _tokens(cfg, 1, 24, 5)
    gt = _jlogits(jp, jcfg, toks)
    np.testing.assert_allclose(_logits(tp, cfg, toks), gt, rtol=TOL, atol=TOL)
    # an 8-slot ring buffer: decode wraps round it
    _check_prefill_decode(cfg, tp, gt, toks, 16, 24)


def _zero_routers(tree, zeros):
    if isinstance(tree, dict):
        return {k: zeros(v) if k == "router" else _zero_routers(v, zeros)
                for k, v in tree.items()}
    return tree


@pytest.mark.parametrize("arch", ARCHES + MOE_PAIRS)
def test_bf16_forward_stays_near_the_reference(arch):
    """bf16 weights and activations: the two frameworks round intermediates
    at other places (measured: 0.9% of max |logit| for llama, 2.9% for rwkv,
    whose decay exp(-exp(.)) magnifies them), so the bar is 5e-2 of max
    |logit| and the same argmax at 90% of positions.

    The MoE pairs run with their routers zeroed.  With a random router, a
    rounding at a near tie sends a token to another expert: the reference
    moves its own bf16 logits by 2-23% of max under one rounding of its
    input (every embedding entry's last bit, token seeds 6-9), and the port
    lies that far from it.  A zero router routes by the tie rule alone
    (experts 0..k-1, each taking its first ``capacity`` tokens and dropping
    the rest), so this holds the bf16 arithmetic of the attention or Mamba
    mixers, the experts, the shared experts, the gates and the drops
    (measured over token seeds 6-13: 0.8-1.3% for deepseek, 2.8-4.0% for
    jamba).  ``tests/test_torch_moe.py`` holds a random router in bf16 on
    the same input at the layer."""
    cfg, jcfg, tp, jp = _pair(arch, dtype="bfloat16")
    if cfg.moe is not None:
        tp = _zero_routers(tp, torch.zeros_like)
        jp = _zero_routers(jp, jnp.zeros_like)
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
    """Every one of the ten names equals the reference's config, in all six
    families (deepseek-moe-16b all 28 layers MoE as the reference keeps
    them, qwen3-moe-235b-a22b with its 128 experts top-8 over H 64 and K 4,
    whisper-tiny and internvl2-76b with their frontends' fields)."""
    from repro.configs import ARCHS as JARCHS
    assert ARCHS == JARCHS
    for name in ARCHS:
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jget_config(name))
    assert {get_config(n).family for n in ARCHS} == {
        "dense", "moe", "ssm", "hybrid", "encdec", "vlm"}
    deepseek = get_config("deepseek-moe-16b")
    assert deepseek.param_counts()["total"] == 16_879_568_896
    assert all(deepseek.is_moe_layer(i) for i in range(deepseek.n_layers))
    qwen3 = get_config("qwen3-moe-235b-a22b")
    assert qwen3.n_heads * qwen3.hd == 2 * qwen3.d_model
    assert qwen3.param_counts() == jget_config("qwen3-moe-235b-a22b").param_counts()
    with pytest.raises(KeyError):
        get_config("gpt-5")


def test_unported_branches_raise():
    """No branch of the model or the registry raises any more: the
    encoder-decoder and VLM trees build (the encoder stacked on its own
    leading axis, the projector), and so does a reduced qwen3-moe tree,
    every layer MoE; the registry has no refusal left."""
    assert not hasattr(T, "_unported")
    import repro_torch.configs as C
    assert not hasattr(C, "UNPORTED")
    whisper = reduced(get_config("whisper-tiny"))
    spec = T.param_spec(whisper)
    assert tuple(spec["enc"]["layers"]["attn"]["wq"].shape) == (
        whisper.n_enc_layers, whisper.d_model, whisper.n_heads * whisper.hd)
    assert tuple(spec["enc"]["proj"].shape) == (whisper.d_frontend, whisper.d_model)
    assert "cross" in spec["layers"]["l0"] and "cross" not in spec["enc"]["layers"]
    vlm = reduced(get_config("internvl2-76b"))
    assert set(T.param_spec(vlm)["projector"]) == {"w1", "b1", "w2", "b2"}
    qwen3 = reduced(get_config("qwen3-moe-235b-a22b"))
    for spec in (T.param_spec(qwen3), T.init_params(0, qwen3, device="cpu")):
        assert set(spec["layers"]) == {"l0"}
        w = spec["layers"]["l0"]["ffn"]
        assert tuple(w["router"].shape) == (qwen3.n_layers, qwen3.d_model, qwen3.moe.n_experts)
        assert "shared" not in w
    # jamba as configured builds with its MoE on every second layer; with
    # moe=None (configs.SERVED) every FFN is dense
    jamba = reduced(get_config("jamba-v0.1-52b"))
    for spec in (T.param_spec(jamba), T.init_params(0, jamba, device="cpu")):
        assert set(spec["layers"]) == {f"l{j}" for j in range(8)}
        assert "attn" in spec["layers"]["l4"] and "mamba" in spec["layers"]["l0"]
        assert [j for j in range(8) if "router" in spec["layers"][f"l{j}"]["ffn"]] == [1, 3, 5, 7]
        w = spec["layers"]["l1"]["ffn"]
        assert w["router"].dtype == torch.float32 and "shared" not in w
        assert tuple(w["w_down"].shape) == (1, 4, 64, jamba.d_model)
    spec = T.param_spec(dataclasses.replace(jamba, moe=None))
    assert all("router" not in spec["layers"][f"l{j}"]["ffn"] for j in range(8))


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
    assert {"mesh.py", "serve.py", "train.py"} <= {f.name for f in files
                                                    if f.parent.name == "launch"}
    assert {"rules.py", "blocks.py"} <= {f.name for f in files if f.parent.name == "sharding"}
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


# qwen3-moe-235b-a22b at a small width that keeps what ``reduced`` erases:
# n_heads * head_dim (256) unequal to d_model (128), a GQA group of 16, and
# top-8 routing over 16 experts (capacity int(T * 8/16 * 1.25) a group)
QWEN3_SHAPED = dict(n_layers=2, d_model=128, n_heads=16, n_kv_heads=1, head_dim=16,
                    d_ff=64, vocab=512, dtype="float32")
# f32 against the reference: the two frameworks sum in other orders
QWEN3_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _qwen3_pair():
    from repro.models.common import MoEConfig as JMoEConfig
    from repro_torch.models.common import MoEConfig
    moe = dict(n_experts=16, top_k=8, d_expert=32)
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"), moe=MoEConfig(**moe),
                              **QWEN3_SHAPED)
    jcfg = dataclasses.replace(jget_config("qwen3-moe-235b-a22b"), moe=JMoEConfig(**moe),
                               **QWEN3_SHAPED)
    jp = jax.jit(lambda: JT.init_params(jax.random.PRNGKey(3), jcfg))()
    tp = transformer_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jcfg, tp, jp


def _close(got, want, tol):
    """``got`` within ``tol`` of max |want|."""
    want = np.asarray(want, np.float32)
    assert np.abs(np.asarray(got, np.float32) - want).max() <= tol * np.abs(want).max()


def test_qwen3_shaped_forward_and_routing_equal_the_reference(monkeypatch):
    """The forward at 1e-5 of max, and each MoE layer's routing (every
    token's 8 experts in order, the kept pairs) exactly the reference's on
    the port's input to the layer, with pairs dropped at capacity."""
    from test_torch_moe import _ref_routing
    cfg, jcfg, tp, jp = _qwen3_pair()
    assert cfg.n_heads * cfg.hd != cfg.d_model and cfg.n_heads // cfg.n_kv_heads == 16
    toks = _tokens(cfg, 2, 24, 3)
    inputs, plain = [], M.moe_ffn

    def kept(x, p, m, **kw):
        inputs.append((x, p))
        return plain(x, p, m, **kw)
    monkeypatch.setattr(M, "moe_ffn", kept)
    _close(_logits(tp, cfg, toks), _jlogits(jp, jcfg, toks), QWEN3_TOL)
    assert len(inputs) == cfg.n_layers
    for x, p in inputs:
        r = M.route(M.groups(x), p["router"], cfg.moe)
        jidx, jkeep = jax.jit(lambda x, w: _ref_routing(x, {"router": w}, jcfg.moe,
                                                        M.GROUP_CHUNK))(
            jnp.asarray(x.numpy()), jnp.asarray(p["router"].numpy()))
        np.testing.assert_array_equal(r.experts.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal((r.slot >= 0).numpy(), np.asarray(jkeep))
        assert int((r.slot < 0).sum()) > 0


def test_qwen3_shaped_prefill_then_decode_equal_the_reference():
    """prefill + serve_step against the reference's jitted ``prefill`` +
    ``serve_step`` at 1e-5 of max; the prefill drops pairs at capacity, a
    decode step none."""
    cfg, jcfg, tp, jp = _qwen3_pair()
    toks = _tokens(cfg, 2, 24, 4)
    n_prompt, cache_len = 16, 32
    jprefill = jax.jit(JT.prefill, static_argnums=(1, 3))
    jstep = jax.jit(JT.serve_step, static_argnums=(1,))
    with torch.inference_mode():
        x = torch.from_numpy(toks[:, :n_prompt])
        logits, cache, pos = T.prefill(tp, cfg, {"tokens": x}, cache_len)
        jlogits, jcache, _ = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :n_prompt])},
                                      cache_len)
        _close(logits.numpy(), jlogits, QWEN3_TOL)
        h = T.embed_inputs(tp, cfg, {"tokens": x})[0]
        assert int(M.dropped_pairs(h, T._group(tp["layers"], 0)["l0"]["ffn"], cfg.moe)) > 0
        for i in range(n_prompt, toks.shape[1]):
            step = torch.from_numpy(toks[:, i:i + 1])
            logits, cache = T.serve_step(tp, cfg, cache, step, i)
            jlogits, jcache = jstep(jp, jcfg, jcache, jnp.asarray(toks[:, i:i + 1]),
                                    jnp.asarray(i, jnp.int32))
            _close(logits.numpy(), jlogits, QWEN3_TOL)
            h = T.embed_inputs(tp, cfg, {"tokens": step})[0]
            assert int(M.dropped_pairs(h, T._group(tp["layers"], 0)["l0"]["ffn"], cfg.moe,
                                       group_chunk=1)) == 0


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_served_forward_routes_jamba_moe_as_prefill_and_serve_step(monkeypatch):
    """``chip_smoke.served_forward`` on reduced jamba with its MoE (MoE
    layers behind Mamba mixers and behind its attention layer): its logits
    at the prompt's last position and at each served one against the
    reference's own ``prefill`` + ``serve_step`` fed the same tokens, and
    its prefill drops layer by layer equal to the port's prefill's."""
    smoke = _chip_smoke()
    cfg, jcfg, tp, jp = _f32_pair("jamba-v0.1-52b-moe")
    assert any(d.ffn == "moe" and d.mixer == "mamba" for d in T.block_structure(cfg)[0])
    toks = _tokens(cfg, 2, 24, 4)
    n_prompt = 16
    with torch.inference_mode():
        x, drops = smoke.served_forward(tp, cfg, torch.from_numpy(toks), n_prompt)
        got = T.logits_from_x(tp, cfg, x[:, n_prompt - 1:]).float().numpy()
    jprefill = jax.jit(JT.prefill, static_argnums=(1, 3))
    jstep = jax.jit(JT.serve_step, static_argnums=(1,))
    jlogits, jcache, _ = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :n_prompt])}, 32)
    want = [np.asarray(jlogits, np.float32)]
    for i in range(n_prompt, toks.shape[1]):
        jlogits, jcache = jstep(jp, jcfg, jcache, jnp.asarray(toks[:, i:i + 1]),
                                jnp.asarray(i, jnp.int32))
        want.append(np.asarray(jlogits))
    np.testing.assert_allclose(got, np.stack(want, 1), rtol=TOL, atol=TOL)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    assert len(drops["prefill"]) == len(drops["decode"]) == n_moe
    assert sum(drops["prefill"]) > 0 and sum(drops["decode"]) == 0
    counted = _counting_drops(monkeypatch)
    with torch.inference_mode():
        T.prefill(tp, cfg, {"tokens": torch.from_numpy(toks[:, :n_prompt])}, 32)
    assert counted == drops["prefill"]
