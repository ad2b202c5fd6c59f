"""The port's launchers and mesh constructors (``repro_torch.launch``) on the
CPU: ``serve.main`` gives the tokens of a direct ``ServingEngine`` run,
``train.main`` trains and checkpoints, both refuse a missing card, the
sharded ``--mesh`` refuses a world below the production mesh's ranks, and
``make_production_mesh`` keeps the
reference's shape rule (``repro.launch.mesh``, its ``jax.make_mesh``
intercepted: a CPU test has no 256 devices).  About 10 s.
"""
import math
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

import repro.launch.mesh as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import reduced  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.training import checkpoint  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module (six test processes
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-1.6b"])
def test_serve_gives_the_tokens_of_a_direct_engine_run(arch, capsys):
    done = serve.main(["--arch", arch, "--batch", "3", "--prompt-len", "12", "--max-new", "5",
                       "--device", "cpu"])
    cfg = reduced(get_config(arch))
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 12).astype(np.int32), max_new=5)
            for i in range(3)]
    engine = ServingEngine(cfg, T.init_params(0, cfg, device="cpu"), cache_slots=12 + 5 + 8,
                           device="cpu")
    want = [r.out for r in engine.run(reqs)]
    assert [r.out for r in done] == want
    lines = capsys.readouterr().out.splitlines()
    assert lines[:3] == [f"req {i}: {out}" for i, out in enumerate(want)]
    assert lines[-1].startswith("15 tokens in ") and lines[-1].endswith("tok/s on the host CPU)")


def test_train_checkpoints_its_final_parameters(tmp_path, capsys):
    path = str(tmp_path / "llama.npz")
    params, metrics = train.main(["--arch", "llama3.2-3b", "--steps", "3", "--batch", "2",
                                  "--seq", "16", "--ckpt", path, "--log-every", "1",
                                  "--device", "cpu"])
    losses = [float(line.split()[3]) for line in capsys.readouterr().out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert losses[-1] == pytest.approx(float(metrics["loss"]), abs=1e-4)
    restored = checkpoint.restore(path, params)
    for got, want in zip(tree_leaves(restored), tree_leaves(params)):
        assert torch.equal(got, want)
    fresh = T.init_params(0, reduced(get_config("llama3.2-3b")), device="cpu")
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(fresh)))


@pytest.mark.parametrize("main", [serve.main, train.main])
def test_launchers_refuse_a_missing_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "llama3.2-3b"])


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_train_refuses_a_sharded_mesh(mesh, monkeypatch):
    """``--mesh`` starts the group from the environment, as ``torchrun``
    sets it, and refuses a world below the production mesh's ranks."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for key, value in dict(RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, MASTER_ADDR="localhost",
                           MASTER_PORT=port).items():
        monkeypatch.setenv(key, str(value))
    need = {"pod": 256, "multipod": 512}[mesh]
    with pytest.raises(ValueError, match=f"needs {need} ranks; the world has 1"):
        train.main(["--arch", "llama3.2-3b", "--mesh", mesh, "--device", "cpu"])
    assert not dist.is_initialized()


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("model_axis", [8, 16])
def test_production_mesh_shape_is_the_reference_s(monkeypatch, multi_pod, model_axis):
    seen = []
    monkeypatch.setattr(JM.jax, "make_mesh", lambda shape, axes, **kw: seen.append((shape, axes)))
    JM.make_production_mesh(multi_pod=multi_pod, model_axis=model_axis)
    assert [M.production_mesh_shape(multi_pod=multi_pod, model_axis=model_axis)] == seen


def test_production_mesh_refuses_an_axis_that_does_not_divide_256():
    with pytest.raises(ValueError, match="does not divide 256"):
        M.production_mesh_shape(model_axis=12)


def test_meshes_in_a_one_rank_world(tmp_path):
    with pytest.raises(RuntimeError, match="no process group"):
        M.make_host_mesh(device="cpu")
    M.start_process_group("gloo", 0, 1, f"file://{tmp_path}/rdv", device="cpu", timeout_s=30)
    try:
        mesh = M.make_host_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="needs 256 ranks; the world has 1"):
            M.make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="differ in length"):
            M.make_mesh_compat((1,), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


def test_start_process_group_refuses_an_unknown_backend(tmp_path):
    with pytest.raises(ValueError, match="unknown backend"):
        M.start_process_group("mpi", 0, 1, f"file://{tmp_path}/rdv", device="cpu")
