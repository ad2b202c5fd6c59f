"""The port's continuous batcher (``repro_torch/serving/continuous.py``)
against the JAX package's (``repro/serving/continuous.py``) on the CPU,
with the same weights (the reference's init, carried across through numpy).

Bars, fixed before measuring: the served tokens equal, request by request,
and every tick's logits (each slot's row, active or not) within 1e-5 of max
|logit| in f32, the two frameworks summing in other orders.  The
reference's ``prefill`` runs under ``jax.jit`` (its batcher calls it op by
op, and each JAX primitive then compiles on its own).  33.5 s of test time
in a 6-worker run.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import reduced as jreduced  # noqa: E402
from repro.serving import continuous as JC  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import reduced  # noqa: E402
from repro_torch.params import transformer_params_from_numpy  # noqa: E402
from repro_torch.serving.continuous import (ContinuousBatcher, StreamRequest,  # noqa: E402
                                            serve_step_multi)
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

TOL = 1e-5
# one config a family the batcher serves: dense, ssm, moe
FAMILY_ARCHS = ["llama3-8b", "rwkv6-1.6b", "deepseek-moe-16b"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module (six test processes
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jitted_reference_prefill():
    """The reference batcher's ``prefill`` under ``jax.jit``, one compile a
    prompt length."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "prefill", jax.jit(JT.prefill, static_argnums=(1, 3)))
        yield


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(port cfg, reference cfg, port params, reference params): reduced, 2
    layers, f32, the reference's init carried across."""
    cfg = dataclasses.replace(reduced(get_config(arch), n_layers=2), dtype="float32")
    jcfg = dataclasses.replace(jreduced(jget_config(arch), n_layers=2), dtype="float32")
    jp = jax.jit(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))()
    tp = transformer_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jcfg, tp, jp


def _requests(cls, prompts, max_new, arrivals):
    return [cls(rid=i, prompt=p, max_new=m, arrival=a)
            for i, (p, m, a) in enumerate(zip(prompts, max_new, arrivals))]


def _kept_ticks(batcher):
    """Wrap the batcher's step to keep each tick's logits as numpy."""
    ticks, step = [], batcher._step

    def kept(*args):
        logits, cache = step(*args)
        ticks.append(np.asarray(logits, np.float32))
        return logits, cache
    batcher._step = kept
    return ticks


def _both(arch, prompts, max_new, arrivals, n_slots, cache_len):
    """Run the port's and the reference's batchers on the same requests;
    returns (port finished, reference finished, port ticks, reference ticks)."""
    cfg, jcfg, tp, jp = _pair(arch)
    port = ContinuousBatcher(cfg, tp, n_slots=n_slots, cache_len=cache_len, device="cpu")
    ref = JC.ContinuousBatcher(jcfg, jp, n_slots=n_slots, cache_len=cache_len)
    ticks, jticks = _kept_ticks(port), _kept_ticks(ref)
    done = port.run(_requests(StreamRequest, prompts, max_new, arrivals))
    jdone = ref.run(_requests(JC.StreamRequest, prompts, max_new, arrivals))
    return done, jdone, ticks, jticks


def _close(got, want):
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_matches_single_request_decode():
    """The twin of ``tests/test_continuous_batching.py``'s first test: two
    slots, three requests arriving every other tick, each request's tokens
    those of the reference's batcher and of serving it alone."""
    cfg, _, tp, _ = _pair("llama3-8b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (8, 12, 5)]
    done, jdone, ticks, jticks = _both("llama3-8b", prompts, (6, 6, 6), (0, 2, 4), 2, 128)
    assert len(done) == 3
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in jdone]
    for i, p in enumerate(prompts):
        [alone] = ServingEngine(cfg, tp, cache_slots=128, device="cpu").run(
            [Request(rid=0, prompt=p, max_new=6)])
        assert {r.rid: r.out for r in done}[i] == alone.out
    assert len(ticks) == len(jticks)
    for got, want in zip(ticks, jticks):
        _close(got, want)


def test_staggered_arrivals_fill_slots():
    """The twin of the second test: five requests arriving a tick apart on
    two slots all finish with their 4 tokens, the reference's."""
    cfg, *_ = _pair("llama3-8b")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, 6).astype(np.int32) for _ in range(5)]
    done, jdone, _, _ = _both("llama3-8b", prompts, (4,) * 5, range(5), 2, 64)
    assert len(done) == 5 and all(len(r.out) == 4 and r.done for r in done)
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in jdone]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_refills_mid_decode_equal_the_reference(arch):
    """Ragged prompts (one of a single token), arrivals while other slots
    decode and ``max_new`` from 2 to 7 on three slots, so slots free and
    refill mid-decode (a refilled slot takes its request's prefilled cache
    rows or rwkv state whole, while the other slots keep theirs).  Tokens
    equal and every tick's logits at 1e-5 of max, for a dense, an ssm and an
    MoE config."""
    cfg, *_ = _pair(arch)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (9, 1, 14, 4, 11, 6)]
    done, jdone, ticks, jticks = _both(arch, prompts, (5, 2, 7, 3, 4, 6), (0, 0, 0, 1, 3, 4),
                                       3, 32)
    assert len(done) == 6 and all(len(r.out) == r.max_new for r in done)
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in jdone]
    assert len(ticks) == len(jticks) > max(r.max_new for r in done)
    for got, want in zip(ticks, jticks):
        _close(got, want)


def test_serve_step_multi_writes_each_row_at_its_own_position():
    """One step from a prefilled cache with a position for each row (one
    row past the ring's end): the logits at 1e-5 of max of the reference's
    ``serve_step_multi``, and k, v and ``kv_pos`` written at each row's own
    ``pos % sc`` and nowhere else."""
    cfg, jcfg, tp, jp = _pair("llama3-8b")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (3, 10)).astype(np.int32)
    step = np.array([[5], [7], [11]], np.int32)
    pos = np.array([10, 13, 21], np.int32)
    with torch.inference_mode():
        _, cache, _ = T.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, 16)
        before = {k: t.clone() for k, t in cache["l0"].items()}
        logits, cache = serve_step_multi(tp, cfg, cache, torch.from_numpy(step),
                                         torch.from_numpy(pos))
    _, jcache, _ = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 16)
    jlogits, jcache = jax.jit(JC.serve_step_multi, static_argnums=(1,))(
        jp, jcfg, jcache, jnp.asarray(step), jnp.asarray(pos))
    _close(logits.numpy(), np.asarray(jlogits))
    np.testing.assert_array_equal(cache["l0"]["kv_pos"].numpy(), np.asarray(jcache["l0"]["kv_pos"]))
    changed = (cache["l0"]["k"] != before["k"]).any(-1).any(-1)       # (G, B, Sc)
    want = torch.zeros_like(changed)
    want[:, torch.arange(3), torch.from_numpy(pos % 16).long()] = True
    assert torch.equal(changed, want)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-tiny", "internvl2-76b"])
def test_other_families_raise(arch):
    """The reference asserts the dense, moe and ssm families; the port
    raises ``ValueError`` for the hybrid, encoder-decoder and VLM ones."""
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    with pytest.raises(ValueError, match=cfg.family):
        ContinuousBatcher(cfg, {}, n_slots=2, cache_len=16, device="cpu")
