"""The port's VLM family (reduced internvl2-76b, f32 unless stated) on the
CPU against the JAX package with the same weights: the projected patch
prefix, forward, prefill + decode against the reference's own ``prefill``
+ ``serve_step``, the bf16 leaves, a bf16 model fed f32 patch embeddings
(JAX promotes), ``ServingEngine``'s greedy tokens (zero patches, as both
engines feed them) and the layered view, whose embed layer takes the whole
batch.  The helpers and bars are ``tests/test_torch_encdec.py``'s.  18 s
of test time in a 6-worker run of the whole suite.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import transformer as JT  # noqa: E402
from repro.models.layered import transformer_as_layered as j_layered  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layered import transformer_as_layered  # noqa: E402
from test_torch_encdec import (TOL, check_bf16_forward, check_bf16_leaves,  # noqa: E402
                               check_engine, check_prefill_decode, front, make_pair,
                               port_logits, ref_logits, to_jax, to_torch, tokens)

NAME = "internvl2-76b"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return make_pair(NAME)


def test_patch_prefix_matches_the_reference(pair):
    """``tanh(pe @ w1 + b1) @ w2 + b2`` before the token embeddings, the
    positions over both; zero patches give a zero prefix."""
    cfg, jcfg, tp, jp = pair
    batch = {"tokens": tokens(cfg, 2, 10, 1), **front(cfg, 2, 2)}
    with torch.inference_mode():
        x, positions, enc_out = T.embed_inputs(tp, cfg, to_torch(batch))
    jx, jpos, _ = JT.embed_inputs(jp, jcfg, to_jax(batch))
    assert enc_out is None and tuple(x.shape) == (2, cfg.n_patches + 10, cfg.d_model)
    np.testing.assert_array_equal(positions.numpy(), np.asarray(jpos))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(x[:, cfg.n_patches:].numpy(),
                                  tp["embed"][torch.from_numpy(batch["tokens"]).long()].numpy())
    zero = {**to_torch(batch), "patch_embeds": torch.zeros(2, cfg.n_patches, cfg.d_frontend)}
    assert not T.embed_inputs(tp, cfg, zero)[0][:, :cfg.n_patches].any()


def test_forward_logits_match_the_reference(pair):
    cfg, jcfg, tp, jp = pair
    batch = {"tokens": tokens(cfg, 2, 24, 3), **front(cfg, 2, 4)}
    got = port_logits(tp, cfg, to_torch(batch))
    assert got.shape == (2, cfg.n_patches + 24, cfg.vocab)
    np.testing.assert_allclose(got, ref_logits(jp, jcfg, to_jax(batch)), rtol=TOL, atol=TOL)


def test_prefill_then_decode_equal_the_reference_prefill_and_serve_step(pair):
    """The decode positions run on after the patches: the first served
    token sits at P + the prompt's length."""
    cfg, jcfg, tp, jp = pair
    batch = {"tokens": tokens(cfg, 2, 24, 4), **front(cfg, 2, 5)}
    check_prefill_decode(pair, batch, 16, 64)
    gt = ref_logits(jp, jcfg, to_jax(batch))
    p = cfg.n_patches
    with torch.inference_mode():
        logits, cache, pos = T.prefill(tp, cfg, to_torch({**batch, "tokens":
                                                          batch["tokens"][:, :16]}), 64)
        assert pos == p + 16
        np.testing.assert_allclose(logits.numpy(), gt[:, p + 15], rtol=TOL, atol=TOL)
        for i in range(16, 24):
            logits, cache = T.serve_step(tp, cfg, cache,
                                         torch.from_numpy(batch["tokens"][:, i:i + 1]), p + i)
            np.testing.assert_allclose(logits.numpy(), gt[:, p + i], rtol=TOL, atol=TOL)


def test_bf16_leaves_cross_bit_for_bit():
    cfg, tp = check_bf16_leaves(NAME)
    pj = tp["projector"]
    assert {k: tuple(v.shape) for k, v in pj.items()} == {
        "w1": (cfg.d_frontend, cfg.d_model), "b1": (cfg.d_model,),
        "w2": (cfg.d_model, cfg.d_model), "b2": (cfg.d_model,)}
    assert "enc" not in tp


@pytest.mark.parametrize("front_dtype", ["bfloat16", "float32"])
def test_bf16_forward_stays_near_the_reference(front_dtype):
    got, _ = check_bf16_forward(NAME, front_dtype)
    assert got.dtype == np.float32


def test_serving_engine_gives_the_reference_greedy_tokens(pair):
    check_engine(pair)


def test_layered_view_matches_forward_and_reference(pair):
    cfg, jcfg, tp, jp = pair
    lay, jlay = transformer_as_layered(cfg, tp), j_layered(jcfg, jp)
    assert [l.name for l in lay.layers] == [l.name for l in jlay.layers]
    assert lay.cut_points() == jlay.cut_points()
    batch = {"tokens": tokens(cfg, 2, 12, 8), **front(cfg, 2, 9)}
    with torch.inference_mode():
        got = lay.apply(lay.init(0, device="cpu"), to_torch(batch)).numpy()
    want = np.asarray(jax.jit(lambda x: jlay.apply(jlay.init(jax.random.PRNGKey(0)), x))(
        to_jax(batch)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, port_logits(tp, cfg, to_torch(batch)), rtol=1e-6, atol=1e-6)
