"""``tests/test_torch_train.py``'s loss and gradient hold for the MoE and
hybrid archs (deepseek-moe-16b, qwen3-moe-235b-a22b, jamba-v0.1-52b with
its MoE), reduced and in f32, with their routing: each MoE layer's experts
equal to the reference's top-k of the same input, and equal again when the
layer's group is recomputed in the backward.  Bars as there.  jamba's
takes about 12 s alone, the others 3-4 s.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train import MOE_ARCHS, check_loss_and_gradients  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module (six test processes
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_gradients_equal_the_reference(arch, monkeypatch):
    check_loss_and_gradients(arch, monkeypatch)
