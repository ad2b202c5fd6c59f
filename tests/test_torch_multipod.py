"""The port's multi-pod split pipeline (``repro_torch.core.split``) against
the reference's ``multipod_split_step`` and against the port's own
one-process composition, on the CPU.

The reference runs as ``examples/multipod_pipeline.py`` runs it, but in a
subprocess on a (2, 1, 1) ``("pod", "data", "model")`` mesh of two host
devices: ``XLA_FLAGS`` must be set before JAX starts, so not in this
process.  Weights and AE are drawn here with numpy and handed to it and,
through ``transformer_params_from_numpy`` and ``ae_from_numpy``, to the
port's two spawned ``gloo`` ranks, which run while it does; it writes its
logits and int8 codes back as numpy.  Config:
``reduced(llama3-8b, n_layers=4, dtype="float32")``, tokens (8, 16) from
numpy, ``n_micro`` 4.  Tolerances: raw and ``ae_f32`` logits within the
reference's own bar (``tests/test_multipod.py``, 1e-4; they sit near 5e-6
of |logit| up to 4.6); the int8 wire's codes within one step (C2), and its
logits within 1e-4 plus the logits' response to moving every code by one
step.  The port's pipeline equals its one-process composition
(``sequential_split_step``) bit for bit.  About 30 s of test time.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import split as S  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import reduced  # noqa: E402
from repro_torch.params import ae_from_numpy, transformer_params_from_numpy  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BATCH, SEQ, N_MICRO, TOKEN_SEED = 8, 16, 4, 1
BAR = 1e-4            # tests/test_multipod.py's bar on the reference's own pipeline
SPAWN_S = 120.0       # each spawn's deadline
REF_S = 300           # the reference subprocess's

REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core import bottleneck as B
from repro.core.split import multipod_split_step
from repro.launch.mesh import make_mesh_compat
from repro.models import transformer as T
from repro.models.common import reduced

with open(sys.argv[1], "rb") as f:
    given = pickle.load(f)
cfg = reduced(get_config("llama3-8b"), n_layers=4, dtype="float32")
params, ae = jax.tree.map(jnp.asarray, given["params"]), jax.tree.map(jnp.asarray, given["ae"])
tokens, n_micro = given["tokens"], given["n_micro"]
mesh = make_mesh_compat((2, 1, 1), ("pod", "data", "model"))
out = {"logits": {}}
for mode, a, quant in (("raw", None, False), ("ae_f32", ae, False), ("ae_int8", ae, True)):
    out["logits"][mode] = np.asarray(multipod_split_step(
        params, cfg, {"tokens": jnp.asarray(tokens)}, mesh, ae=a, n_micro=n_micro,
        quantize_wire=quant))
descs, n_groups = T.block_structure(cfg)

@jax.jit
def head_wire(tok):  # the head stage of the reference's pipeline, then its int8 wire
    x = params["embed"][tok]
    pos = jnp.arange(tok.shape[1])
    for g in range(n_groups // 2):
        lp = jax.tree.map(lambda a: a[g], params["layers"])
        x, _, _ = T.apply_layer_seq(lp["l0"], descs[0], x, cfg, pos, causal=True,
                                    window=cfg.sliding_window)
    return B.encode_wire(ae, x.astype(jnp.float32))

out["codes"] = [tuple(np.asarray(c) for c in head_wire(jnp.asarray(t)))
                for t in tokens.reshape(n_micro, -1, tokens.shape[1])]
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _cfg(**changes):
    return reduced(get_config("llama3-8b"), **{"n_layers": 4, "dtype": "float32", **changes})


def _tokens(cfg, batch=BATCH):
    rng = np.random.default_rng(TOKEN_SEED)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (batch, SEQ)).astype(np.int32))


def _numpy_inputs(cfg, seed=0) -> tuple:
    """Weights in the reference's tree (``param_spec``'s shapes) and a
    rate-0.5 AE, drawn with numpy: norm gains near 1, the embedding at
    0.02, every other matrix at 1 / sqrt(fan-in), each vector at 0.1."""
    rng = np.random.default_rng(seed)

    def draw(spec, path):
        if isinstance(spec, dict):
            return {k: draw(v, path + (k,)) for k, v in spec.items()}
        shape = tuple(spec.shape)
        if any(p.startswith("norm") or p == "final_norm" for p in path):
            base = 1.0 if path[-1] == "w" else 0.0
            return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if path == ("embed",):
            return (0.02 * rng.standard_normal(shape)).astype(np.float32)
        scale = shape[-2] ** -0.5 if len(shape) >= 2 else 0.1
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    d, lat = cfg.d_model, cfg.d_model // 2
    ae = {"enc": {"w": (d ** -0.5 * rng.standard_normal((d, lat))).astype(np.float32),
                  "b": (0.1 * rng.standard_normal(lat)).astype(np.float32)},
          "dec": {"w": (lat ** -0.5 * rng.standard_normal((lat, d))).astype(np.float32),
                  "b": (0.1 * rng.standard_normal(d)).astype(np.float32)}}
    return draw(T.param_spec(cfg), ()), ae


def _refusal(fn) -> str:
    """The message of the ``ValueError`` that ``fn()`` raises ("" if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _pipeline_rank(rank, world, tmp, params, ae, tokens, cfg):
    """One of two ranks: nccl refused on one host device, then the three
    wire modes over gloo, then the refusals (each raises before any
    message crosses)."""
    torch.set_num_threads(1)
    out = {"nccl": _refusal(lambda: M.start_process_group(
        "nccl", rank, world, f"file://{tmp}/nccl", device="cpu", timeout_s=60))}
    M.start_process_group("gloo", rank, world, f"file://{tmp}/gloo", device="cpu",
                          timeout_s=60)
    try:
        mesh = M.make_mesh_compat((2, 1, 1), ("pod", "data", "model"), device="cpu")
        stage = mesh.get_local_rank("pod")
        tree = S.stage_params(params, cfg, stage)
        out["stage"] = stage
        for mode in S.WIRE_MODES:
            logits = S.multipod_split_step(tree, cfg, {"tokens": tokens}, mesh,
                                           ae=None if mode == "raw" else ae, n_micro=N_MICRO,
                                           quantize_wire=mode == "ae_int8")
            out[mode] = {"logits": None if logits is None else logits.numpy(),
                         "wire_bytes": S.multipod_split_step.wire_bytes[mode]}
        step = S.multipod_split_step
        flat = M.make_mesh_compat((2,), ("data",), device="cpu")
        one_pod = M.make_mesh_compat((1, 2), ("pod", "data"), device="cpu")
        jamba = reduced(get_config("jamba-v0.1-52b"), dtype="float32")
        out["refusals"] = {
            "odd_groups": _refusal(lambda: step(tree, _cfg(n_layers=3), {"tokens": tokens},
                                                mesh, ae=None)),
            "non_uniform": _refusal(lambda: step(tree, jamba, {"tokens": tokens}, mesh,
                                                 ae=None)),
            "batch": _refusal(lambda: step(tree, cfg, {"tokens": tokens[:6]}, mesh, ae=None)),
            "pod_axis": _refusal(lambda: step(tree, cfg, {"tokens": tokens}, one_pod, ae=None)),
            "no_pod_axis": _refusal(lambda: step(tree, cfg, {"tokens": tokens}, flat, ae=None)),
        }
    finally:
        dist.destroy_process_group()
    return out


def _replica_rank(rank, world, tmp, params, tokens, cfg):
    """One of four ranks on a (pod 2, data 2) mesh: each data column is a
    pipeline of its own, fed its own half of the tokens."""
    torch.set_num_threads(1)
    M.start_process_group("gloo", rank, world, f"file://{tmp}/rdv", device="cpu", timeout_s=60)
    try:
        mesh = M.make_mesh_compat((2, 2), ("pod", "data"), device="cpu")
        stage, column = mesh.get_local_rank("pod"), mesh.get_local_rank("data")
        half = tokens[column * 4:(column + 1) * 4]
        logits = S.multipod_split_step(S.stage_params(params, cfg, stage), cfg,
                                       {"tokens": half}, mesh, ae=None, n_micro=2)
    finally:
        dist.destroy_process_group()
    return stage, column, None if logits is None else logits.numpy()


def _late_rank(rank, world, tmp):
    """Rank 1 never reaches the rendezvous, so rank 0 must give up and fail."""
    if rank == 0:
        M.start_process_group("gloo", rank, world, f"file://{tmp}/rdv", device="cpu",
                              timeout_s=1)
    return "absent"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module (six test processes
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    cfg = _cfg()
    return (cfg, *_numpy_inputs(cfg))


@pytest.fixture(scope="module")
def port(inputs):
    cfg, params, ae = inputs
    return (cfg, transformer_params_from_numpy(cfg, params, device="cpu"),
            ae_from_numpy(ae, device="cpu"))


@pytest.fixture(scope="module")
def reference_run(inputs, tmp_path_factory):
    """The reference's pipeline on the same numpy inputs, started here and
    left running while the port's ranks run; :func:`reference` waits."""
    cfg, params, ae = inputs
    tmp = tmp_path_factory.mktemp("reference")
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({"params": params, "ae": ae, "tokens": _tokens(cfg).numpy(),
                     "n_micro": N_MICRO}, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, str(tmp / "inputs.pkl"),
                             str(tmp / "out.pkl")], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, tmp / "out.pkl"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ranks(reference_run, port, tmp_path_factory):
    cfg, params, ae = port
    tmp = tmp_path_factory.mktemp("ranks")
    out = M.spawn_ranks(_pipeline_rank, 2, (str(tmp), params, ae, _tokens(cfg), cfg),
                        timeout_s=SPAWN_S)
    return {r["stage"]: r for r in out}


@pytest.fixture(scope="module")
def reference(reference_run, ranks):
    proc, path = reference_run
    _, err = proc.communicate(timeout=REF_S)
    assert proc.returncode == 0, err[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _wire(ae, mode):
    return None if mode == "raw" else ae


@pytest.mark.parametrize("mode", S.WIRE_MODES)
def test_pipeline_equals_the_sequential_composition_bit_for_bit(ranks, port, mode):
    cfg, params, ae = port
    want = S.sequential_split_step(params, cfg, {"tokens": _tokens(cfg)}, ae=_wire(ae, mode),
                                   n_micro=N_MICRO, quantize_wire=mode == "ae_int8")
    assert ranks[0][mode]["logits"] is None
    assert np.array_equal(ranks[1][mode]["logits"], want.numpy())


@pytest.mark.parametrize("mode", S.WIRE_MODES)
def test_wire_bytes_count_the_head_s_sends(ranks, mode):
    cfg = _cfg()
    latent = cfg.d_model // 2
    tokens = BATCH * SEQ
    want = {"raw": tokens * cfg.d_model * 4, "ae_f32": tokens * latent * 4,
            "ae_int8": tokens * latent + tokens * 4}[mode]
    assert ranks[0][mode]["wire_bytes"] == want
    assert ranks[1][mode]["wire_bytes"] == 0


@pytest.mark.parametrize("case, words", [
    ("odd_groups", "do not halve"), ("non_uniform", "uniform stacks"),
    ("batch", "microbatches"), ("pod_axis", "pod axis has 1"), ("no_pod_axis", "'pod' axis")])
def test_pipeline_refuses_what_the_reference_asserts(ranks, case, words):
    for rank in ranks.values():
        assert words in rank["refusals"][case], rank["refusals"][case]


def test_nccl_refuses_two_ranks_on_one_device(ranks):
    for rank in ranks.values():
        assert "ranks 0 and 1 are both on cpu" in rank["nccl"], rank["nccl"]
    with pytest.raises(ValueError, match="both on cuda:0"):
        M.refuse_shared_devices("nccl", ["h/cuda:0", "h/cuda:1", "h/cuda:0"])
    M.refuse_shared_devices("nccl", ["h/cuda:0", "h/cuda:1", "g/cuda:0"])
    M.refuse_shared_devices("gloo", ["h/cuda:0", "h/cuda:0"])


def test_raw_composition_equals_the_forward(port):
    cfg, params, _ = port
    batch = {"tokens": _tokens(cfg)}
    with torch.no_grad():
        want = T.logits_from_x(params, cfg, T.forward(params, cfg, batch)["x"])
    got = S.sequential_split_step(params, cfg, batch, ae=None, n_micro=N_MICRO)
    assert (got - want).abs().max() <= BAR


def test_stage_params_hold_one_pod_s_share_as_views(port):
    cfg, params, _ = port
    head, tail = S.stage_params(params, cfg, 0), S.stage_params(params, cfg, 1)
    assert set(head) == {"layers", "embed"}
    assert set(tail) == {"layers", "final_norm", "head"}
    wq = params["layers"]["l0"]["attn"]["wq"]
    for stage, tree in ((0, head), (1, tail)):
        part = tree["layers"]["l0"]["attn"]["wq"]
        assert part.shape[0] == wq.shape[0] // 2
        assert part.untyped_storage().data_ptr() == wq.untyped_storage().data_ptr()
        assert torch.equal(part, wq[stage * 2:(stage + 1) * 2])
    tied = S.stage_params(params, _cfg(tie_embeddings=True), 1)
    assert set(tied) == {"layers", "final_norm", "embed"}
    with pytest.raises(ValueError, match="uniform stacks"):
        S.stage_params(params, reduced(get_config("jamba-v0.1-52b")), 0)
    with pytest.raises(ValueError, match="stages 0 and 1"):
        S.stage_params(params, cfg, 2)


def test_stage_trees_leave_nothing_behind(port):
    """Both stage trees together hold every layer leaf once."""
    cfg, params, _ = port
    halves = [tree_leaves(S.stage_params(params, cfg, s)["layers"]) for s in (0, 1)]
    for whole, a, b in zip(tree_leaves(params["layers"]), *halves):
        assert torch.equal(torch.cat([a, b]), whole)


def test_each_data_column_is_a_pipeline_of_its_own(port, tmp_path):
    """Rank (0, i) sends to rank (1, i): the two columns get different
    tokens and each tail holds its own column's logits."""
    cfg, params, _ = port
    tokens = _tokens(cfg)
    out = M.spawn_ranks(_replica_rank, 4, (str(tmp_path), params, tokens, cfg),
                        timeout_s=SPAWN_S)
    tails = {column: logits for stage, column, logits in out if stage == 1}
    assert all(logits is None for stage, _, logits in out if stage == 0)
    assert sorted(tails) == [0, 1]
    for column, logits in tails.items():
        want = S.sequential_split_step(params, cfg, {"tokens": tokens[column * 4:(column + 1) * 4]},
                                       ae=None, n_micro=2)
        assert np.array_equal(logits, want.numpy())


def test_a_rank_that_never_arrives_fails_the_spawn(tmp_path):
    """Rank 0 waits 1 s for rank 1's placement, raises, and ``spawn_ranks``
    raises with its traceback instead of waiting out its deadline."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 of 2 failed(.|\n)*Timeout waiting for key"):
        M.spawn_ranks(_late_rank, 2, (str(tmp_path),), timeout_s=SPAWN_S)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("mode", ["raw", "ae_f32"])
def test_pipeline_matches_the_reference(ranks, reference, mode):
    got, want = ranks[1][mode]["logits"], reference["logits"][mode]
    assert got.shape == want.shape == (BATCH, SEQ, _cfg().vocab)
    assert np.abs(got - want).max() <= BAR


def test_int8_wire_matches_the_reference(ranks, reference, port):
    """Codes within one step and scales within 1e-5 of the reference's; the
    port's tail on the reference's own wire within 1e-4 of its logits; the
    pipeline's logits within 1e-4 plus their response to one step of every
    code."""
    cfg, params, ae = port
    head, tail = S.stage_params(params, cfg, 0), S.stage_params(params, cfg, 1)
    tokens, mb = _tokens(cfg), BATCH // N_MICRO
    want = reference["logits"]["ae_int8"]
    step = 0.0
    for i, (q_ref, s_ref) in enumerate(reference["codes"]):
        q, s = S.wire_encode(ae, S.head_stage(head, cfg, tokens[i * mb:(i + 1) * mb]), "ae_int8")
        assert np.abs(q.numpy().astype(int) - q_ref.astype(int)).max() <= 1
        assert np.abs(s.numpy() - s_ref).max() <= 1e-5 * np.abs(s_ref).max()
        on_ref = S.tail_stage(tail, cfg, S.wire_decode(
            ae, (torch.from_numpy(q_ref), torch.from_numpy(s_ref)), "ae_int8", cfg.tdtype))
        assert np.abs(on_ref.numpy() - want[i * mb:(i + 1) * mb]).max() <= BAR
        base = S.tail_stage(tail, cfg, S.wire_decode(ae, (q, s), "ae_int8", cfg.tdtype))
        moved = (q.int() + 1).clamp(-127, 127).to(torch.int8)
        up = S.tail_stage(tail, cfg, S.wire_decode(ae, (moved, s), "ae_int8", cfg.tdtype))
        step = max(step, float((up - base).abs().max()))
    assert step > 0
    assert np.abs(ranks[1]["ae_int8"]["logits"] - want).max() <= BAR + step
