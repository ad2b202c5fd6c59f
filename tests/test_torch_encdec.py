"""The port's encoder-decoder family (reduced whisper-tiny, f32 unless
stated) on the CPU against the JAX package with the same weights:
``layernorm`` and ``gelu_mlp``, the encoder, forward, prefill + decode
against the reference's own ``prefill`` + ``serve_step``, the bf16 leaves,
a bf16 model fed f32 frames (JAX promotes), ``ServingEngine``'s greedy
tokens, the layered view (which, as the reference's, skips the encoder and
every cross-attention), and the plain ``flash_attention`` at the
cross-attention's shape, Sq > Sk without a mask, against the Pallas kernel
in interpret mode and its oracle.

Bars, fixed before measuring: f32 logits within 1e-3 (the two frameworks
sum in other orders; ``tests/test_torch_zoo.py``'s bar), the norms and
MLPs within 1e-5 of max, attention within ``tests/test_kernels.py``'s
2e-5, bf16 logits within 5e-2 of max |logit| with the same argmax at 90%
of positions (``tests/test_torch_zoo.py``'s bf16 bar).  42 s of test time
in a 6-worker run of the whole suite.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import reduced as jreduced  # noqa: E402
from repro.models.layered import transformer_as_layered as j_layered  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import reduced  # noqa: E402
from repro_torch.models.layered import transformer_as_layered  # noqa: E402
from repro_torch.params import transformer_params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

NAME = "whisper-tiny"
TOL = 1e-3
BF16_REL = 5e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module (six test processes
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_pair(name, dtype="float32", **overrides):
    """(port cfg, reference cfg, port params, reference params): the reduced
    config of ``name``, the reference's weights carried over through numpy."""
    cfg = dataclasses.replace(reduced(get_config(name)), dtype=dtype, **overrides)
    jcfg = dataclasses.replace(jreduced(jget_config(name)), dtype=dtype, **overrides)
    jp = jax.jit(lambda: JT.init_params(jax.random.PRNGKey(1), jcfg))()
    tp = transformer_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jcfg, tp, jp


def front(cfg, b, seed, dtype=np.float32) -> dict:
    """The stub frontend's input of ``cfg``, N(0, 1) from numpy: frames for
    an encoder-decoder, patch embeddings for a VLM."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal((b, cfg.n_frames, cfg.d_frontend)).astype(dtype)}
    return {"patch_embeds": rng.standard_normal((b, cfg.n_patches, cfg.d_frontend)).astype(dtype)}


def tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def to_torch(batch, dtype=None):
    return {k: torch.from_numpy(v) if v.dtype == np.int32 or dtype is None
            else torch.from_numpy(v).to(dtype) for k, v in batch.items()}


def to_jax(batch, dtype=None):
    return {k: jnp.asarray(v) if v.dtype == np.int32 or dtype is None
            else jnp.asarray(v, dtype) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jitted():
    return (jax.jit(JT.forward, static_argnums=(1,)),
            jax.jit(JT.prefill, static_argnums=(1, 3)),
            jax.jit(JT.serve_step, static_argnums=(1,)))


def port_logits(tp, cfg, batch):
    with torch.inference_mode():
        return T.logits_from_x(tp, cfg, T.forward(tp, cfg, batch)["x"]).float().numpy()


def ref_logits(jp, jcfg, batch):
    out = _jitted()[0](jp, jcfg, batch)
    return np.asarray(JT.logits_from_x(jp, jcfg, out["x"]).astype(jnp.float32))


def check_prefill_decode(pair, batch, n_prompt, cache_len):
    """The port's prefill + serve_step against the reference's, step by step,
    fed the same tokens; ``batch``'s tokens run past the prompt."""
    cfg, jcfg, tp, jp = pair
    _, jprefill, jstep = _jitted()
    toks = batch["tokens"]
    first = {**batch, "tokens": toks[:, :n_prompt]}
    with torch.inference_mode():
        logits, cache, pos = T.prefill(tp, cfg, to_torch(first), cache_len)
        jlogits, jcache, jpos = jprefill(jp, jcfg, to_jax(first), cache_len)
        assert pos == int(jpos)
        np.testing.assert_allclose(logits.float().numpy(), np.asarray(jlogits, np.float32),
                                   rtol=TOL, atol=TOL)
        for i in range(n_prompt, toks.shape[1]):
            logits, cache = T.serve_step(tp, cfg, cache, torch.from_numpy(toks[:, i:i + 1]),
                                         pos + i - n_prompt)
            jlogits, jcache = jstep(jp, jcfg, jcache, jnp.asarray(toks[:, i:i + 1]),
                                    jnp.asarray(int(jpos) + i - n_prompt, jnp.int32))
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=TOL, atol=TOL)
    return cache


def check_bf16_leaves(name):
    """Every bf16 leaf of the reference's tree arrives bit for bit."""
    cfg, _, tp, jp = make_pair(name, dtype="bfloat16")
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    assert any(a.dtype == jnp.bfloat16 for _, a in leaves)
    for path, a in leaves:
        t = tp
        for key in path:
            t = t[key.key]
        a = np.asarray(a)
        assert t.dtype == (torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32)
        got = t.view(torch.int16 if a.dtype.itemsize == 2 else torch.int32).numpy()
        np.testing.assert_array_equal(got, a.view(got.dtype))
    return cfg, tp


def check_engine(pair, lens=(5, 12, 9), news=(6, 4, 6)):
    """``ServingEngine``'s greedy tokens (zero frontend inputs in the
    config's dtype, as both engines feed them) against the reference's."""
    cfg, jcfg, tp, jp = pair
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    got = ServingEngine(cfg, tp, cache_slots=32, device="cpu").run(
        [Request(i, p, max_new=m) for i, (p, m) in enumerate(zip(prompts, news))])
    want = JEngine(jcfg, jp, cache_slots=32).run(
        [JRequest(i, p, max_new=m) for i, (p, m) in enumerate(zip(prompts, news))])
    assert [r.out for r in got] == [r.out for r in want]
    assert [len(r.out) for r in got] == list(news)


def check_bf16_forward(name, front_dtype):
    """A bf16 model fed frontend inputs in ``front_dtype``: an f32 input is
    promoted by JAX (the encoder or projector in f32), and so by the port."""
    cfg, jcfg, tp, jp = make_pair(name, dtype="bfloat16")
    batch = {"tokens": tokens(cfg, 2, 16, 6), **front(cfg, 2, 7)}
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if front_dtype == "bfloat16"
                else (torch.float32, jnp.float32))
    got = port_logits(tp, cfg, to_torch(batch, tdt))
    want = ref_logits(jp, jcfg, to_jax(batch, jdt))
    assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9
    return got, want


@pytest.fixture(scope="module")
def pair():
    return make_pair(NAME)


def test_layernorm_and_gelu_mlp_match_the_reference():
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 5, 48)) + 1).astype(np.float32)
    w, b = rng.standard_normal(48).astype(np.float32), rng.standard_normal(48).astype(np.float32)
    p = {"w_in": rng.standard_normal((48, 96)).astype(np.float32) / 7,
         "b_in": rng.standard_normal(96).astype(np.float32),
         "w_out": rng.standard_normal((96, 48)).astype(np.float32) / 10,
         "b_out": rng.standard_normal(48).astype(np.float32)}
    for dtype in ("float32", "bfloat16"):
        tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
        got = TL.layernorm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                           torch.from_numpy(b).to(tdt), 1e-5)
        want = JL.layernorm(jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt), 1e-5)
        assert got.dtype == tdt
        # f32: the same math; bf16: one rounding of the same f32 result
        bar = 1e-5 if dtype == "float32" else 1e-2
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=bar, atol=bar * np.abs(np.asarray(want, np.float32)).max())
    got = TL.gelu_mlp(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()})
    want = np.asarray(JL.gelu_mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # the tanh form: the exact erf GELU is another function
    exact = torch.nn.functional.gelu(torch.from_numpy(x @ p["w_in"] + p["b_in"]))
    approx = torch.from_numpy(np.array(jax.nn.gelu(jnp.asarray(x @ p["w_in"] + p["b_in"]))))
    assert float((exact - approx).abs().max()) > 1e-4


def test_encoder_matches_the_reference(pair):
    cfg, jcfg, tp, jp = pair
    frames = front(cfg, 2, 3)["frames"]
    with torch.inference_mode():
        got = T._encoder(tp, cfg, torch.from_numpy(frames)).numpy()
    want = np.asarray(jax.jit(lambda p, f: JT._encoder(p, jcfg, f, None))(jp, frames))
    assert got.shape == (2, cfg.n_frames, cfg.d_model)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s", [8, 24])
def test_forward_logits_match_the_reference(pair, s):
    """Prompts shorter and longer than the 16 frames: the cross-attention
    runs at Sq < Sk and at Sq > Sk."""
    cfg, jcfg, tp, jp = pair
    batch = {"tokens": tokens(cfg, 2, s, 3), **front(cfg, 2, 4)}
    np.testing.assert_allclose(port_logits(tp, cfg, to_torch(batch)),
                               ref_logits(jp, jcfg, to_jax(batch)), rtol=TOL, atol=TOL)


def test_prefill_then_decode_equal_the_reference_prefill_and_serve_step(pair):
    cfg, jcfg, tp, jp = pair
    batch = {"tokens": tokens(cfg, 2, 24, 4), **front(cfg, 2, 5)}
    cache = check_prefill_decode(pair, batch, 16, 64)
    assert tuple(cache["l0"]["ck"].shape) == (cfg.n_layers, 2, cfg.n_frames, cfg.n_heads, cfg.hd)
    # and the steps reproduce one forward over the same frames
    gt = ref_logits(jp, jcfg, to_jax(batch))
    with torch.inference_mode():
        first = to_torch({**batch, "tokens": batch["tokens"][:, :16]})
        logits, cache, pos = T.prefill(tp, cfg, first, 64)
        np.testing.assert_allclose(logits.numpy(), gt[:, 15], rtol=TOL, atol=TOL)
        for i in range(16, 24):
            logits, cache = T.serve_step(tp, cfg, cache,
                                         torch.from_numpy(batch["tokens"][:, i:i + 1]), i)
            np.testing.assert_allclose(logits.numpy(), gt[:, i], rtol=TOL, atol=TOL)


def test_bf16_leaves_cross_bit_for_bit():
    cfg, tp = check_bf16_leaves(NAME)
    enc = tp["enc"]
    assert tuple(enc["layers"]["attn"]["bq"].shape) == (cfg.n_enc_layers, cfg.n_heads * cfg.hd)
    assert tuple(enc["pos"].shape) == (cfg.n_frames, cfg.d_model)
    cross = tp["layers"]["l0"]["cross"]
    assert tuple(cross["wk"].shape) == (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.hd)
    assert set(cross) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}
    assert set(tp["layers"]["l0"]["ffn"]) == {"w_in", "b_in", "w_out", "b_out"}


@pytest.mark.parametrize("front_dtype", ["bfloat16", "float32"])
def test_bf16_forward_stays_near_the_reference(front_dtype):
    check_bf16_forward(NAME, front_dtype)


def test_serving_engine_gives_the_reference_greedy_tokens(pair):
    check_engine(pair)


def test_layered_view_skips_the_encoder_as_the_reference_does(pair):
    """The reference's view calls each block without the encoder's output
    (``repro/models/layered.py:119-122``), so a whisper view's logits are
    the decoder's with every cross-attention skipped, and the frames change
    nothing; the port's view does the same."""
    cfg, jcfg, tp, jp = pair
    lay, jlay = transformer_as_layered(cfg, tp), j_layered(jcfg, jp)
    assert [l.name for l in lay.layers] == [l.name for l in jlay.layers]
    assert lay.cut_points() == jlay.cut_points()
    batch = {"tokens": tokens(cfg, 2, 12, 8), **front(cfg, 2, 9)}
    with torch.inference_mode():
        got = lay.apply(lay.init(0, device="cpu"), to_torch(batch)).numpy()
        zero = lay.apply([{}] * len(lay.layers),
                         {**to_torch(batch), "frames": torch.zeros(2, cfg.n_frames,
                                                                   cfg.d_frontend)}).numpy()
    want = np.asarray(jax.jit(lambda x: jlay.apply(jlay.init(jax.random.PRNGKey(0)), x))(
        to_jax(batch)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got, zero)
    assert np.abs(got - port_logits(tp, cfg, to_torch(batch))).max() > 10 * TOL


# b, sq, sk, h, kh, d: whole 128-row tiles (the Pallas kernel asserts them)
CROSS_CASES = [(2, 256, 128, 4, 4, 64), (1, 384, 256, 4, 2, 64), (1, 256, 128, 2, 2, 128)]


@pytest.mark.parametrize("case", CROSS_CASES)
def test_cross_attention_flash_matches_pallas_kernel_and_ref(case):
    """Sq > Sk without a mask, the cross-attention of a prompt longer than
    the frames: the plain version against the Pallas kernel in interpret
    mode and ``ref.flash_attention_ref``, launching nothing on the CPU."""
    b, sq, sk, h, kh, d = case
    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, kh, d)).astype(np.float32) for _ in range(2))
    before = launch_counts()
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=False).numpy()
    assert launch_counts() == before
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for want in (pallas_flash(jq, jk, jv, causal=False, interpret=True),
                 jref.flash_attention_ref(jq, jk, jv, causal=False)):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)


def test_sq_above_sk_is_refused_under_a_mask():
    """Under a causal or window mask the first Sq - Sk rows would see no
    key: the TPU kernel writes them as 0, a plain softmax as the mean of v,
    so the port takes Sq > Sk only without a mask."""
    q, kv = torch.zeros(1, 9, 4, 64), torch.zeros(1, 8, 2, 64)
    assert flash_attention(q, kv, kv, causal=False).shape == q.shape
    for kw in ({"causal": True}, {"causal": False, "window": 4}):
        with pytest.raises(ValueError, match="Sq 9 > Sk 8"):
            flash_attention(q, kv, kv, **kw)
