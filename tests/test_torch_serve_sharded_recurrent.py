"""The port's sharded serving of the ssm, hybrid and encoder-decoder
families (``sharding/parallel.py``; ``prefill`` / ``serve_step`` /
``init_cache`` / ``ServingEngine`` with a mesh) on the CPU, the twin of the
reference's ``shard_fn=`` serving path with its recurrent and cross caches
under ``cache_specs``.

Four spawned ``gloo`` ranks (``file://`` rendezvous, one torch thread a
rank), on ("data", "model") meshes of (2, 2) and (1, 4), serve reduced f32
rwkv6-1.6b (4 heads of 32), jamba-v0.1-52b as served (``configs.SERVED``:
``moe=None``; one 8-layer period, the attention layer at index 4 and 7 Mamba
layers, d_inner 256) and whisper-tiny (its encoder over 16 frames, 4 heads,
the GELU MLP, a cross-attention a layer), B 4 of 10 tokens, a prefill and 6
decode steps under teacher forcing (the one-process run's greedy tokens fed
to both), with weights ``init_params(..., mesh=, profile="inference")``
draws block by block:

* against the one-process port: every step's whole (B, V) logits within
  ``BAR`` (1e-5) of its max |logit| on every rank, and each rank's cache
  blocks (``wkv``, ``tm_prev``, ``cm_prev``, ``conv``, ``ssm``, ``ck``,
  ``cv``, ``k``, ``v``; ``kv_pos`` exactly), after the prefill and after the
  last step, equal to its block of the one-process cache under
  ``cache_specs`` at the same bar;
* against the reference: its ``prefill`` and ``serve_step`` under
  ``jax.jit`` on a (2, 2) host mesh with ``param_specs(profile=
  "inference")``, ``cache_specs``, ``batch_specs`` and ``make_shard_fn``, in
  a subprocess started with the module's first test
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``), from numpy
  weights carried over by ``transformer_params_from_numpy`` and cut by
  ``shard_tree``: logits within ``REF_BAR`` (1e-4) of each step's max;
* the edge routes: rwkv with 2 heads of 64 on (1, 4), whose ``w[rkvg]``
  columns the rules cut mid-head, all-gathers its time-mix leaves (the
  bytes counted exactly at the prefill) and keeps a replicated ``wkv``;
  jamba on (1, 4), where ranks 2 and 3 hold ``in_proj`` columns that are all
  z, exchanges x and z by one all-to-all a Mamba layer (the bytes counted
  exactly); whisper with 6 heads of 32 (d_model 192) on (1, 4) runs its
  self- and cross-attention whole with a replicated ``ck``/``cv``, and on
  (2, 2) on 3 heads a rank; B 3, which "data" does not divide, runs every
  row on every rank;
* ``ServingEngine(mesh=)``'s tokens equal the one-process engine's on every
  rank for rwkv, jamba and whisper, each step's top-2 margin over 10x the
  bar;
* ``init_cache(mesh=)`` gives each leaf its block under ``cache_specs`` and
  ``init_params(mesh=)`` bit for bit ``shard_tree(init_params(...))``.

51.0 s of test time in a 6-worker run with ``--dist loadfile`` (the
reference's compiles beside the ranks), about 30 s alone.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import SERVED, get_config  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import reduced  # noqa: E402
from repro_torch.params import transformer_params_from_numpy  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402
from repro_torch.sharding import blocks  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_serve_sharded import (MESHES, At, _check_cache, _check_logits,  # noqa: E402
                                      _numpy, _requests, _sharded, _torch)
from test_torch_train import numpy_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPAWN_S, REF_S = 240.0, 300
BAR, REF_BAR = 1e-5, 1e-4
B, TEXT, STEPS, SLOTS = 4, 10, 6, 24
ARCHS = ("rwkv6-1.6b", "jamba-v0.1-52b", "whisper-tiny")
WHISPER6 = {"d_model": 192, "n_heads": 6, "n_kv_heads": 6, "head_dim": 32}
# the edge cases: (arch, config changes, mesh, batch, cache slots)
EDGES = {"rwkv_misaligned": ("rwkv6-1.6b", {"rwkv_head_dim": 64}, "1x4", B, SLOTS),
         "whisper_6_heads_1x4": ("whisper-tiny", WHISPER6, "1x4", B, SLOTS),
         "whisper_6_heads_2x2": ("whisper-tiny", WHISPER6, "2x2", B, SLOTS),
         "rwkv_rows_replicated": ("rwkv6-1.6b", {}, "2x2", 3, SLOTS),
         "jamba_rows_replicated": ("jamba-v0.1-52b", {}, "2x2", 3, SLOTS)}
# the engine's requests: (arch, mesh, prompt lengths, max_new)
ENGINES = {"rwkv_2x2": ("rwkv6-1.6b", "2x2", (10, 7, 3, 9), (6, 4, 6, 5)),
           "jamba_1x4": ("jamba-v0.1-52b", "1x4", (8, 5, 10, 2), (5, 6, 3, 6)),
           "whisper_2x2": ("whisper-tiny", "2x2", (9, 4, 6, 7), (6, 6, 2, 4))}

REFERENCE = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_mesh_compat
from repro.models import transformer as T
from repro.models.common import reduced
from repro.sharding import rules

with open(sys.argv[1], "rb") as f:
    given = pickle.load(f)
mesh = make_mesh_compat((2, 2), ("data", "model"))
shard_fn = rules.make_shard_fn(mesh)
out = {}
for arch, case in given.items():
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32", **case["changes"])
    params = jax.device_put(jax.tree.map(jnp.asarray, case["params"]), rules.to_shardings(
        rules.param_specs(case["params"], mesh, profile="inference"), mesh))
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    batch = jax.device_put(batch, rules.to_shardings(rules.batch_specs(batch, mesh), mesh))
    prefill = jax.jit(lambda p, b: T.prefill(p, cfg, b, case["slots"], shard_fn=shard_fn))
    step = jax.jit(lambda p, c, t, pos: T.serve_step(p, cfg, c, t, pos, shard_fn=shard_fn))
    with mesh:
        logits, cache, pos = prefill(params, batch)
        cache = jax.device_put(cache, rules.to_shardings(rules.cache_specs(cache, mesh), mesh))
        rows = [np.asarray(logits, np.float32)]
        for i, tok in enumerate(case["tokens"]):
            tok = jnp.asarray(tok)
            tok = jax.device_put(tok, rules.to_shardings(rules.batch_specs(tok, mesh), mesh))
            logits, cache = step(params, cache, tok, pos + i)
            rows.append(np.asarray(logits, np.float32))
    out[arch] = rows
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module (six test processes
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, **changes):
    """The reduced f32 config as served (jamba without its MoE)."""
    return dataclasses.replace(reduced(get_config(arch), dtype="float32"),
                               **{**SERVED.get(arch, {}), **changes})


def _batch(cfg, b, seed=1) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, TEXT)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(b, cfg.n_frames, cfg.d_frontend)).astype(np.float32)
    return out


def _one_process(params, cfg, batch, slots) -> dict:
    """Prefill and ``STEPS`` greedy steps in one process: each step's
    logits (the prefill's first), the tokens fed, the cache after the
    prefill and after the last step, as numpy."""
    logits, cache, pos = T.prefill(params, cfg, _torch(batch), slots)
    out = {"logits": [logits.float().numpy().copy()], "tokens": [],
           "cache_prefill": _numpy(cache)}
    for i in range(STEPS):
        token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out["tokens"].append(token.numpy().copy())
        logits, cache = T.serve_step(params, cfg, cache, token, pos + i)
        out["logits"].append(logits.numpy().copy())
    out["cache_last"] = _numpy(cache)
    return out


def _rank(rank, world, tmp, cases, ref_cases, engines):
    torch.set_num_threads(1)
    M.start_process_group("gloo", rank, world, f"file://{tmp}/rdv", device="cpu",
                          timeout_s=SPAWN_S)
    out = {"cases": {}, "init": {}, "cache_shapes": {}, "reference": {}, "engines": {}}
    try:
        meshes = {name: M.make_mesh_compat(shape, ("data", "model"), device="cpu")
                  for name, shape in MESHES.items()}
        out["coords"] = {name: blocks.coordinates(mesh) for name, mesh in meshes.items()}
        for key, (arch, changes, mesh, batch, slots, tokens) in cases.items():
            cfg, mesh = _cfg(arch, **changes), meshes[mesh]
            params = T.init_params(0, cfg, device="cpu", mesh=mesh, profile="inference")
            out["cases"][key] = _sharded(params, cfg, batch, slots, tokens, mesh)
            whole = T.init_params(0, cfg, device="cpu")
            want = blocks.shard_tree(whole, R.param_specs(whole, mesh, "inference"), mesh)
            out["init"][key] = all(a.shape == b.shape and torch.equal(a, b)
                                   for a, b in zip(tree_leaves(params), tree_leaves(want)))
            cache = T.init_cache(cfg, len(batch["tokens"]), slots, device="cpu", mesh=mesh)
            out["cache_shapes"][key] = {layer: {k: tuple(t.shape) for k, t in leaves.items()}
                                        for layer, leaves in cache.items()}
        for arch, (params, batch, slots, tokens) in ref_cases.items():
            cfg, mesh = _cfg(arch), meshes["2x2"]
            mine = blocks.shard_tree(params, R.param_specs(params, mesh, "inference"), mesh)
            out["reference"][arch] = _sharded(mine, cfg, batch, slots, tokens, mesh)["logits"]
        for key, (arch, mesh, requests) in engines.items():
            cfg, mesh = _cfg(arch), meshes[mesh]
            params = T.init_params(0, cfg, device="cpu", mesh=mesh, profile="inference")
            served = E.ServingEngine(cfg, params, cache_slots=SLOTS, device="cpu",
                                     mesh=mesh).run([dataclasses.replace(r, out=[])
                                                     for r in requests])
            out["engines"][key] = [r.out for r in served]
    finally:
        dist.destroy_process_group()
    return out


@pytest.fixture(scope="module")
def ref_inputs():
    """Numpy weights (``numpy_params``) and a batch for each of ``ARCHS``,
    and the one-process port's greedy tokens on them, fed to the reference
    and to the ranks."""
    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        p_np, batch = numpy_params(cfg), _batch(cfg, B, seed=2)
        params = transformer_params_from_numpy(cfg, p_np, device="cpu")
        run = _one_process(params, cfg, batch, SLOTS)
        out[arch] = {"params": p_np, "batch": batch, "slots": SLOTS, "tokens": run["tokens"],
                     "changes": SERVED.get(arch, {}), "port": run["logits"]}
    return out


@pytest.fixture(scope="module")
def reference_run(ref_inputs, tmp_path_factory):
    """The reference's sharded prefill and decode on a (2, 2) host mesh,
    started before the ranks and left running beside them."""
    tmp = tmp_path_factory.mktemp("reference")
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({a: {k: c[k] for k in ("params", "batch", "slots", "tokens", "changes")}
                     for a, c in ref_inputs.items()}, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, str(tmp / "inputs.pkl"),
                             str(tmp / "out.pkl")], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, tmp / "out.pkl"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _cases() -> dict:
    """Every sharded run: each arch on each mesh, then ``EDGES``:
    ``(arch, changes, mesh, batch, slots)``."""
    out = {(arch, mesh): (arch, {}, mesh, B, SLOTS) for arch in ARCHS for mesh in MESHES}
    out.update(EDGES)
    return out


@pytest.fixture(scope="module")
def one_process():
    """The one-process port on every case of :func:`_cases`, from
    ``init_params(0, ...)``."""
    out = {}
    for key, (arch, changes, _, b, slots) in _cases().items():
        cfg = _cfg(arch, **changes)
        batch = _batch(cfg, b)
        out[key] = dict(_one_process(T.init_params(0, cfg, device="cpu"), cfg, batch, slots),
                        batch=batch)
    return out


@pytest.fixture(scope="module")
def ranks(reference_run, ref_inputs, one_process, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    cases = {key: (arch, changes, mesh, one_process[key]["batch"], slots,
                   one_process[key]["tokens"])
             for key, (arch, changes, mesh, _, slots) in _cases().items()}
    ref_cases = {arch: (transformer_params_from_numpy(_cfg(arch), c["params"], device="cpu"),
                        c["batch"], c["slots"], c["tokens"]) for arch, c in ref_inputs.items()}
    engines = {key: (arch, mesh, _requests(lengths, max_new, _cfg(arch).vocab))
               for key, (arch, mesh, lengths, max_new) in ENGINES.items()}
    return M.spawn_ranks(_rank, 4, (str(tmp), cases, ref_cases, engines), timeout_s=SPAWN_S)


@pytest.fixture(scope="module")
def reference(reference_run, ranks):
    proc, path = reference_run
    _, err = proc.communicate(timeout=REF_S)
    assert proc.returncode == 0, err[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_logits_equal_the_one_process_port_s(ranks, one_process, mesh, arch):
    _check_logits([r["cases"][arch, mesh]["logits"] for r in ranks],
                  one_process[arch, mesh]["logits"], BAR)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_rank_holds_its_recurrent_and_cross_cache_blocks(ranks, one_process, mesh, arch):
    """Each rank's ``wkv``, ``tm_prev``, ``cm_prev`` (rwkv), ``conv``,
    ``ssm``, ``k``, ``v``, ``kv_pos`` (jamba), ``k``, ``v``, ``kv_pos``,
    ``ck``, ``cv`` (whisper) blocks after the prefill and the last step."""
    _check_cache(ranks, (arch, mesh), mesh, _cfg(arch), B, SLOTS, one_process[arch, mesh])
    keys = set(one_process[arch, mesh]["cache_last"]["l0"])
    assert keys == {"rwkv6-1.6b": {"wkv", "tm_prev", "cm_prev"},
                    "jamba-v0.1-52b": {"conv", "ssm"},
                    "whisper-tiny": {"k", "v", "kv_pos", "ck", "cv"}}[arch]


@pytest.mark.parametrize("edge", list(EDGES))
def test_edge_routes_equal_the_one_process_port_s(ranks, one_process, edge):
    """Mid-head time-mix columns, 6 heads over 4 and over 2 ranks, rows
    that "data" does not divide: logits and cache blocks at the same
    bars."""
    arch, changes, mesh, b, slots = EDGES[edge]
    _check_logits([r["cases"][edge]["logits"] for r in ranks], one_process[edge]["logits"], BAR)
    _check_cache(ranks, edge, mesh, _cfg(arch, **changes), b, slots, one_process[edge])


def _model_leaves(tree, specs) -> int:
    """Elements of one group's leaves of ``tree`` that "model" cuts."""
    return sum(t[0].numel() for t, s in zip(tree_leaves(tree), tree_leaves(specs))
               if any("model" in R._axes(e) for e in s))


def test_misaligned_time_mix_gathers_its_leaves_and_keeps_the_whole_state(ranks):
    """rwkv with 2 heads of 64 on (1, 4): ``_sanitize`` cuts ``w[rkvg]``'s
    128 columns into half heads and keeps ``wkv``'s 2 heads whole, so each
    layer's time-mix leaves are all-gathered and run whole on every rank: the
    prefill's all-gather bytes are exactly those leaves' a layer, the
    channel-mix gate's columns (B, S, d) a layer, the embedding's rows and
    the vocab columns, and nothing goes through an all-to-all."""
    arch, changes, mesh, b, slots = EDGES["rwkv_misaligned"]
    cfg = _cfg(arch, **changes)
    spec = T.param_spec(cfg)
    specs = R.param_specs(spec, At(mesh, {"data": 0, "model": 0}), "inference")
    assert tuple(specs["layers"]["l0"]["tm"]["wr"]) == (None, None, "model")
    tm = _model_leaves(spec["layers"]["l0"]["tm"], specs["layers"]["l0"]["tm"])
    assert tm == 5 * cfg.d_model ** 2
    d = cfg.d_model
    want = 4 * (cfg.n_layers * (tm + b * TEXT * d) + b * TEXT * d + b * cfg.vocab)
    for r in ranks:
        got = r["cases"]["rwkv_misaligned"]["traffic"]
        assert got["all_gather"] == want, (got, want)
        assert got["all_to_all"] == 0
        shapes = r["cache_shapes"]["rwkv_misaligned"]["l0"]
        assert shapes["wkv"] == (cfg.n_layers, b, 2, 64, 64)          # heads replicated
        assert shapes["tm_prev"] == shapes["cm_prev"] == (cfg.n_layers, b, d // 4)


def test_all_z_in_proj_blocks_get_their_channels_by_one_all_to_all(ranks):
    """jamba on (1, 4): ``in_proj``'s 512 columns are x's 256 then z's, so
    ranks 0-1 hold x only and ranks 2-3 z only; each Mamba layer's
    prefill sends n-column parts (n = d_inner / 4) to every rank, the
    attention layer's k and v go to their slots, and each rank's ``conv``
    and ``ssm`` blocks (its 64 channels) equal the one-process cache's
    (:func:`test_each_rank_holds_its_recurrent_and_cross_cache_blocks`)."""
    cfg = _cfg("jamba-v0.1-52b")
    di, m = mamba_mod.d_inner(cfg), 4
    spec = T.param_spec(cfg)
    n_mamba = sum(1 for layer in spec["layers"].values() if "mamba" in layer)
    assert n_mamba == 7
    n = di // m
    mamba = n_mamba * m * B * TEXT * n * 4
    attn = 2 * B * SLOTS * (cfg.n_kv_heads // m) * cfg.hd * 4
    for r in ranks:
        rank = r["coords"]["1x4"]["model"]
        cols = range(rank * 2 * di // m, (rank + 1) * 2 * di // m)
        assert all(c >= di for c in cols) == (rank >= 2)
        assert r["cases"]["jamba-v0.1-52b", "1x4"]["traffic"]["all_to_all"] == mamba + attn
        shapes = r["cache_shapes"]["jamba-v0.1-52b", "1x4"]["l0"]
        assert shapes == {"conv": (1, B, cfg.mamba_d_conv - 1, n),
                          "ssm": (1, B, n, cfg.mamba_d_state)}


def test_whisper_s_6_heads_run_whole_on_4_ranks_and_split_on_2(ranks):
    """6 heads do not divide over 4 ranks: self- and cross-attention run
    on their leaves all-gathered, the cross cache is replicated and no k or
    v goes through an all-to-all; over 2 ranks each takes 3 heads and its
    ``ck``/``cv`` block."""
    cfg = _cfg("whisper-tiny", **WHISPER6)
    for r in ranks:
        whole = r["cache_shapes"]["whisper_6_heads_1x4"]["l0"]
        assert whole["ck"] == whole["cv"] == (cfg.n_layers, B, cfg.n_frames, 6, cfg.hd)
        assert r["cases"]["whisper_6_heads_1x4"]["traffic"]["all_to_all"] == 0
        split = r["cache_shapes"]["whisper_6_heads_2x2"]["l0"]
        assert split["ck"] == (cfg.n_layers, B // 2, cfg.n_frames, 3, cfg.hd)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_logits_match_the_reference_s_gspmd_serving(ranks, reference, ref_inputs, arch):
    want = reference[arch]
    _check_logits([ref_inputs[arch]["port"]], want, REF_BAR)
    _check_logits([r["reference"][arch] for r in ranks], want, REF_BAR)


@pytest.mark.parametrize("key", list(ENGINES))
def test_the_engine_on_a_mesh_gives_the_one_process_engine_s_tokens(ranks, monkeypatch, key):
    arch, _, lengths, max_new = ENGINES[key]
    cfg = _cfg(arch)
    margins = []

    def watch(fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            top = torch.topk(out[0].float(), 2, dim=-1).values
            margins.append(float(((top[:, 0] - top[:, 1]) / top.abs().max()).min()))
            return out
        return run
    monkeypatch.setattr(T, "prefill", watch(T.prefill))
    monkeypatch.setattr(T, "serve_step", watch(T.serve_step))
    served = E.ServingEngine(cfg, T.init_params(0, cfg, device="cpu"), cache_slots=SLOTS,
                             device="cpu").run(_requests(lengths, max_new, cfg.vocab))
    want = [r.out for r in served]
    assert [len(t) for t in want] == list(max_new)
    # a tie could flip between the runs: each pick stands clear of its bar
    assert min(margins[:max(max_new)]) > 10 * BAR, margins
    for r in ranks:
        assert r["engines"][key] == want


def test_block_init_is_bit_for_bit_the_cut_of_the_whole_tree(ranks):
    for key in _cases():
        for r in ranks:
            assert r["init"][key], key


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_init_cache_on_a_mesh_gives_each_leaf_its_block(mesh, arch):
    """Every rank's ``init_cache(mesh=)`` leaf has its block's shape under
    ``cache_specs`` (the whole cache's slot count kept), the recurrent
    states f32 as in one process."""
    cfg = _cfg(arch)
    whole = T.cache_spec(cfg, B, SLOTS)
    for coord in range(4):
        at = At(mesh, {"data": coord // 2, "model": coord % 2} if mesh == "2x2"
                else {"data": 0, "model": coord})
        specs = R.cache_specs(whole, at)
        cache = T.init_cache(cfg, B, SLOTS, device="cpu", mesh=at)
        assert cache.slots == SLOTS
        for layer, leaves in whole.items():
            assert set(cache[layer]) == set(leaves)
            for key, full in leaves.items():
                want = blocks.local_block(full, specs[layer][key], at)
                assert tuple(cache[layer][key].shape) == tuple(want.shape), (layer, key)
                assert cache[layer][key].dtype == full.dtype, (layer, key)
                assert tuple(want.shape) != tuple(full.shape), (layer, key)
