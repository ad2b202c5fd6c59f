"""The port's sharded serving (``sharding/parallel.py``, ``prefill`` /
``serve_step`` / ``init_cache`` / ``init_params`` / ``ServingEngine`` with a
mesh) on the CPU, the twin of the reference's ``shard_fn=`` serving path.

Four spawned ``gloo`` ranks (``file://`` rendezvous, one torch thread a
rank), on ("data", "model") meshes of (2, 2) and (1, 4), serve reduced f32
llama3.2-3b, qwen2-72b (QKV bias) and internvl2-76b (its patch prefix), B 4
of 10 tokens (internvl: 8 patches before them), a prefill and 6 decode
steps under teacher forcing (the one-process run's greedy tokens fed to
both), with weights ``init_params(..., mesh=, profile="inference")`` draws
block by block:

* against the one-process port: every step's whole (B, V) logits within
  ``BAR`` (1e-5) of its max |logit| on every rank, and each rank's cache
  blocks, after the prefill and after the last step, equal to its block of
  the one-process cache under ``cache_specs`` at the same bar (kv_pos
  exactly);
* against the reference: its ``prefill`` and ``serve_step`` under
  ``jax.jit`` on a (2, 2) host mesh with ``param_specs(profile=
  "inference")``, ``cache_specs``, ``batch_specs`` and ``make_shard_fn``,
  in a subprocess started with the module's first test
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``), from numpy
  weights carried over by ``transformer_params_from_numpy`` and cut by
  ``shard_tree``: logits within ``REF_BAR`` (1e-4) of each step's max;
* the edge routes: llama with 2 kv heads on (1, 4), whose k/v columns the
  rules cut mid-head, all-gathers its attention leaves (the bytes in
  ``blocks.traffic``, counted exactly at the prefill); a 25-slot cache,
  whose slot axis no mesh here cuts, is replicated and no slot counts
  twice; B 3, which "data" does not divide, runs every row on every rank;
  a tied head sums its logits over "model";
* ``ServingEngine(mesh=)``'s tokens equal the one-process engine's on every
  rank, each step's top-2 margin over 10x the bar;
* ``init_params(mesh=)`` bit for bit ``shard_tree(init_params(...))`` in
  both profiles, no stacked leaf ever whole; ``init_train_state(mesh=)``
  the same blocks;
* the refusals: the MoE configs (deepseek-moe-16b, qwen3-moe-235b-a22b and
  jamba-v0.1-52b with its MoE: A14d3) under a mesh; nccl off the card.  The
  ssm, hybrid and encdec families are served in
  ``test_torch_serve_sharded_recurrent.py``.

31.7 s of test time in a 6-worker run with `--dist loadfile` (the
reference's compiles beside the ranks), about 22 s alone.
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

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import reduced  # noqa: E402
from repro_torch.params import transformer_params_from_numpy  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402
from repro_torch.sharding import blocks, parallel  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402
from repro_torch.training import train as TR  # noqa: E402
from repro_torch.training.optimizer import OptConfig  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_train import numpy_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPAWN_S, REF_S = 240.0, 300
BAR, REF_BAR = 1e-5, 1e-4
B, TEXT, STEPS, SLOTS = 4, 10, 6, 24
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
ARCHS = ("llama3.2-3b", "qwen2-72b", "internvl2-76b")
# the edge cases: (name, arch, config changes, mesh, batch, cache slots)
EDGES = {"misaligned": ("llama3.2-3b", {"n_kv_heads": 2}, "1x4", B, SLOTS),
         "replicated_slots_2x2": ("llama3.2-3b", {}, "2x2", B, SLOTS + 1),
         "replicated_slots_1x4": ("internvl2-76b", {}, "1x4", B, SLOTS + 1),
         "rows_replicated": ("qwen2-72b", {}, "2x2", 3, SLOTS),
         "tied_head": ("llama3.2-3b", {"tie_embeddings": True}, "1x4", B, SLOTS)}
# the engine's requests: (arch, mesh, prompt lengths, max_new)
ENGINES = {"llama_2x2": ("llama3.2-3b", "2x2", (10, 7, 3, 9), (6, 4, 6, 5)),
           "internvl_1x4": ("internvl2-76b", "1x4", (8, 5, 10, 2), (5, 6, 3, 6)),
           "qwen_2x2_three": ("qwen2-72b", "2x2", (9, 4, 6), (6, 6, 2))}
# the configs sharded serving refuses: (arch, config changes, ROADMAP item)
REFUSED = {"deepseek-moe-16b": ("deepseek-moe-16b", {}, "A14d3"),
           "qwen3-moe-235b-a22b": ("qwen3-moe-235b-a22b", {}, "A14d3"),
           "jamba-v0.1-52b-with-moe": ("jamba-v0.1-52b", {}, "A14d3")}

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
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
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
    return dataclasses.replace(reduced(get_config(arch), dtype="float32"), **changes)


def _batch(cfg, b, seed=1) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, TEXT)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(size=(b, cfg.n_patches, cfg.d_frontend)).astype(
            np.float32)
    return out


def _torch(batch) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _numpy(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


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


def _sharded(params, cfg, batch, slots, tokens, mesh) -> dict:
    """:func:`_one_process` under ``mesh`` on this rank's blocks, the
    one-process ``tokens`` fed; the collectives' bytes at the prefill."""
    blocks.reset_traffic()
    logits, cache, pos = T.prefill(params, cfg, _torch(batch), slots, mesh=mesh)
    out = {"logits": [logits.float().numpy().copy()], "cache_prefill": _numpy(cache),
           "traffic": dict(blocks.traffic), "slots": cache.slots}
    for i, token in enumerate(tokens):
        logits, cache = T.serve_step(params, cfg, cache, torch.from_numpy(token), pos + i,
                                     mesh=mesh)
        out["logits"].append(logits.numpy().copy())
    out["cache_last"] = _numpy(cache)
    return out


def _rank(rank, world, tmp, cases, ref_cases, engines):
    torch.set_num_threads(1)
    M.start_process_group("gloo", rank, world, f"file://{tmp}/rdv", device="cpu",
                          timeout_s=SPAWN_S)
    out = {"cases": {}, "init": {}, "reference": {}, "engines": {}}
    try:
        meshes = {name: M.make_mesh_compat(shape, ("data", "model"), device="cpu")
                  for name, shape in MESHES.items()}
        out["coords"] = {name: blocks.coordinates(mesh) for name, mesh in meshes.items()}
        for key, (arch, changes, mesh, batch, slots, tokens) in cases.items():
            cfg, mesh = _cfg(arch, **changes), meshes[mesh]
            params = T.init_params(0, cfg, device="cpu", mesh=mesh, profile="inference")
            out["cases"][key] = _sharded(params, cfg, batch, slots, tokens, mesh)
            whole = T.init_params(0, cfg, device="cpu")
            out["init"][key] = {}
            for profile in ("inference", "train"):
                mine = (params if profile == "inference" else
                        T.init_params(0, cfg, device="cpu", mesh=mesh, profile=profile))
                want = blocks.shard_tree(whole, R.param_specs(whole, mesh, profile), mesh)
                out["init"][key][profile] = all(
                    a.shape == b.shape and torch.equal(a, b)
                    for a, b in zip(tree_leaves(mine), tree_leaves(want)))
            state = TR.init_train_state(0, cfg, OptConfig(), device="cpu", mesh=mesh)[0]
            out["init"][key]["train_state"] = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(state), tree_leaves(blocks.shard_tree(
                    whole, R.param_specs(whole, mesh, "train"), mesh))))
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
                     "port": run["logits"]}
    return out


@pytest.fixture(scope="module")
def reference_run(ref_inputs, tmp_path_factory):
    """The reference's sharded prefill and decode on a (2, 2) host mesh,
    started before the ranks and left running beside them."""
    tmp = tmp_path_factory.mktemp("reference")
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({a: {k: c[k] for k in ("params", "batch", "slots", "tokens")}
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


def _requests(lengths, max_new, vocab) -> list:
    rng = np.random.default_rng(3)
    return [E.Request(rid=i, prompt=rng.integers(1, vocab, n).astype(np.int32), max_new=k)
            for i, (n, k) in enumerate(zip(lengths, max_new))]


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


class At:
    """A rank's place on one of ``MESHES``, for ``blocks.local_block``
    outside the group."""

    def __init__(self, mesh, coord):
        self.shape, self.mesh_dim_names = MESHES[mesh], ("data", "model")
        self.coord = coord

    def get_coordinate(self):
        return [self.coord[a] for a in self.mesh_dim_names]


def _gap(got, want) -> float:
    top = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / top


def _check_logits(rows, want, bar):
    for r in rows:
        assert len(r) == len(want)
        for i, (got, ref) in enumerate(zip(r, want)):
            assert got.shape == ref.shape, (i, got.shape, ref.shape)
            assert _gap(got, ref) <= bar, (i, _gap(got, ref))


def _check_cache(ranks, key, mesh, cfg, b, slots, want):
    """Each rank's cache blocks against its block of ``want`` under
    ``cache_specs``: k and v at ``BAR`` of the whole leaf's max (a block
    of slots the prefill did not reach is zeros), kv_pos exactly."""
    specs = R.cache_specs(T.cache_spec(cfg, b, slots), At(mesh, ranks[0]["coords"][mesh]))
    for r in ranks:
        at = At(mesh, r["coords"][mesh])
        for when in ("cache_prefill", "cache_last"):
            got, ref = r["cases"][key][when], want[when]
            for layer in ref:
                for leaf, full in ref[layer].items():
                    blk = blocks.local_block(torch.from_numpy(full), specs[layer][leaf],
                                             at).numpy()
                    mine = got[layer][leaf]
                    assert mine.shape == blk.shape, (when, leaf, mine.shape, blk.shape)
                    if leaf == "kv_pos":
                        assert np.array_equal(mine, blk), (when, r["coords"][mesh])
                    else:
                        gap = float(np.abs(mine - blk).max()) / float(np.abs(full).max())
                        assert gap <= BAR, (when, leaf, gap)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_logits_equal_the_one_process_port_s(ranks, one_process, mesh, arch):
    _check_logits([r["cases"][arch, mesh]["logits"] for r in ranks],
                  one_process[arch, mesh]["logits"], BAR)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_rank_holds_its_blocks_of_the_one_process_cache(ranks, one_process, mesh, arch):
    _check_cache(ranks, (arch, mesh), mesh, _cfg(arch), B, SLOTS, one_process[arch, mesh])
    assert all(r["cases"][arch, mesh]["slots"] == SLOTS for r in ranks)


@pytest.mark.parametrize("edge", list(EDGES))
def test_edge_routes_equal_the_one_process_port_s(ranks, one_process, edge):
    """Mid-head k/v columns, a replicated slot axis, rows that "data" does
    not divide, a tied head (``embed``'s d_model block as rows of
    ``embed.T``, summed): logits and cache blocks at the same bars."""
    arch, changes, mesh, b, slots = EDGES[edge]
    _check_logits([r["cases"][edge]["logits"] for r in ranks], one_process[edge]["logits"], BAR)
    _check_cache(ranks, edge, mesh, _cfg(arch, **changes), b, slots, one_process[edge])


def test_misaligned_heads_gather_the_layer_s_attention_leaves(ranks):
    """llama with 2 kv heads on (1, 4): ``_sanitize`` cuts ``wk``'s 64
    columns into quarter heads, so each layer's attention leaves are
    all-gathered and run whole: the prefill's all-gather bytes are exactly
    those leaves' a layer, the embedding's rows and the vocab columns, and
    nothing goes through an all-to-all (every rank has every head)."""
    arch, changes, mesh, b, slots = EDGES["misaligned"]
    cfg = _cfg(arch, **changes)
    spec = T.param_spec(cfg)
    fake = At(mesh, {"data": 0, "model": 0})
    plan_specs = R.param_specs(spec, fake, "inference")
    assert tuple(plan_specs["layers"]["l0"]["attn"]["wk"]) == (None, None, "model")
    attn = sum(t[0].numel() * 4 for t in tree_leaves(spec["layers"]["l0"]["attn"]))
    seq = TEXT
    want = cfg.n_layers * attn + b * seq * cfg.d_model * 4 + b * cfg.vocab * 4
    for r in ranks:
        got = r["cases"]["misaligned"]["traffic"]
        assert got["all_gather"] == want, (got, want)
        assert got["all_to_all"] == 0


def test_a_replicated_slot_axis_is_exchanged_by_no_all_to_all(ranks):
    for edge in ("replicated_slots_2x2", "replicated_slots_1x4"):
        for r in ranks:
            assert r["cases"][edge]["slots"] == SLOTS + 1
            assert r["cases"][edge]["traffic"]["all_to_all"] == 0
            assert r["cases"][edge]["cache_last"]["l0"]["k"].shape[2] == SLOTS + 1


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
            assert r["init"][key] == {"inference": True, "train": True, "train_state": True}, key


@pytest.mark.parametrize("profile", ["inference", "train"])
def test_block_init_never_stacks_a_whole_leaf(monkeypatch, profile):
    """Every ``torch.stack`` of the block-wise init builds a leaf of the
    rank's block shape: a leaf the rules cut is never whole."""
    cfg = _cfg("internvl2-76b")
    at = At("2x2", {"data": 1, "model": 1})
    whole = T.param_spec(cfg)
    specs = R.param_specs(whole, at, profile)
    want = [tuple(blocks.local_block(t, s, at).shape)
            for t, s in zip(tree_leaves(whole["layers"]), tree_leaves(specs["layers"]))]
    assert want != [tuple(t.shape) for t in tree_leaves(whole["layers"])]
    stacked, stack = [], torch.stack
    monkeypatch.setattr(torch, "stack", lambda ts, *a, **k: stacked.append(
        stack(ts, *a, **k)) or stacked[-1])
    params = T.init_params(0, cfg, device="cpu", mesh=at, profile=profile)
    # the stacks on the CPU, each leaf's in the tree's order (the rules'
    # meta tree is stacked whole, on the meta device)
    assert [tuple(t.shape) for t in stacked if t.device.type == "cpu"] == want
    assert [tuple(t.shape) for t in tree_leaves(params["layers"])] == want


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_a_family_sharded_serving_does_not_take_is_refused(case):
    """Every MoE config, jamba with its MoE too (as served, ``moe=None``, it
    is served), names A14d3."""
    arch, changes, item = REFUSED[case]
    cfg = dataclasses.replace(reduced(get_config(arch), dtype="float32"), **changes)
    assert cfg.moe is not None
    at = At("2x2", {"data": 0, "model": 0})
    with pytest.raises(NotImplementedError, match=item):
        T.prefill(None, cfg, {"tokens": torch.zeros((4, 3), dtype=torch.int32)}, 8, mesh=at)
    with pytest.raises(NotImplementedError, match=item):
        T.serve_step(None, cfg, {}, torch.zeros((4, 1), dtype=torch.int32), 3, mesh=at)
    with pytest.raises(NotImplementedError, match=item):
        T.init_cache(cfg, 4, 8, device="cpu", mesh=at)


def test_nccl_off_the_card_is_refused(tmp_path):
    with pytest.raises(ValueError, match="CUDA tensors only"):
        parallel.check_backend("nccl", "cpu")
    parallel.check_backend("gloo", "cpu")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        M.start_process_group("nccl", 0, 1, f"file://{tmp_path}/rdv", device="cpu",
                              timeout_s=10)


def test_a_plain_cache_or_per_row_positions_under_a_mesh_are_refused():
    cfg = _cfg("llama3.2-3b")
    at = At("1x4", {"data": 0, "model": 0})
    token = torch.zeros((4, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="init_cache"):
        T.serve_step(None, cfg, T.init_cache(cfg, 4, 8, device="cpu"), token, 3, mesh=at)
    cache = parallel.ShardedCache(T.init_cache(cfg, 4, 8, device="cpu"), 8)
    with pytest.raises(ValueError, match="an int"):
        T.serve_step(None, cfg, cache, token, torch.full((4,), 3, dtype=torch.int32), mesh=at)


def _decode_case(seed, b=3, s=12, h=4, kh=2, d=8):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, 1, h, d), generator=g)
    k, v = torch.randn((b, s, kh, d), generator=g), torch.randn((b, s, kh, d), generator=g)
    kv_pos = torch.randperm(s, generator=g).to(torch.int32).expand(b, s).clone()
    kv_pos[:, : s // 3] = -1                    # empty slots, in the first part only
    q_pos = torch.tensor([s - 1, s - 3, s - 6], dtype=torch.int32)
    return q, k, v, kv_pos, q_pos


@pytest.mark.parametrize("window", [None, 4])
def test_partial_attention_combined_is_one_softmax_over_every_slot(window):
    """Slots split into 4 parts (the first all empty, others partly
    masked by position and window) and combined equal ``decode_attention``
    over them all."""
    q, k, v, kv_pos, q_pos = _decode_case(0)
    want = L.decode_attention(q, k, v, kv_pos, q_pos, window)
    outs, lses = [], []
    for lo in range(0, 12, 3):
        o, lse = L.decode_attention_partial(q, k[:, lo:lo + 3], v[:, lo:lo + 3],
                                            kv_pos[:, lo:lo + 3], q_pos, window)
        outs.append(o[:, 0])
        lses.append(lse)
    assert torch.isneginf(lses[0]).all() and not outs[0].any()
    got = L.combine(torch.stack(outs), torch.stack(lses))[:, None]
    assert torch.allclose(got.to(q.dtype), want, atol=1e-6, rtol=0)
    whole = L.decode_attention_partial(q, k, v, kv_pos, q_pos, window)[0]
    assert torch.allclose(whole, want, atol=1e-6, rtol=0)
    # a slot two parts hold counts twice: the parts must not overlap
    twice = L.combine(torch.stack(outs + outs[1:2]), torch.stack(lses + lses[1:2]))[:, None]
    assert not torch.allclose(twice, got, atol=1e-4)
