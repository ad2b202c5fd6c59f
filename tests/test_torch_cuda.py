"""The port on the card: the CUDA kernels, the split runtime and the zoo's
serving path against the port's own CPU path.  Every test here needs an NVIDIA card and skips
without one; on a machine with a card and no JAX, run
``python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``.
"""
import dataclasses
import re
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import bottleneck as B  # noqa: E402
from repro_torch.core import split as SP  # noqa: E402
from repro_torch.kernels import launch_counts, ref, reset_launches, tiles  # noqa: E402
from repro_torch.kernels import bottleneck_compress as comp  # noqa: E402
from repro_torch.kernels.bottleneck_decompress import bottleneck_decompress  # noqa: E402
from repro_torch.kernels.flash_attention import (ROUTES, bwd_kernel_info,  # noqa: E402
                                                 f32_tiles, flash_attention, flash_attention_bwd,
                                                 flash_attention_lse, kernel_info)
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_bwd  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (bwd_workspace, rwkv6_scan,  # noqa: E402
                                            rwkv6_scan_bwd)
from repro_torch.models.vgg import vgg_cifar  # noqa: E402
from repro_torch.runtime.engine import SplitRuntime, run_clients  # noqa: E402
from repro_torch.configs import SERVED, get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import reduced  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

pytestmark = pytest.mark.cuda

# (N, C, L): whole tiles, ragged everywhere, one row, many rows, N = 8 at
# fc0_relu's width, and C and L not multiples of 4 (the 4-byte copies of f
# and w, the byte copies of q)
SHAPES = [(64, 128, 64), (777, 300, 100), (1, 512, 256), (4237, 96, 48), (8, 4096, 2048),
          (33, 301, 99)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available")
    return torch.device("cuda")


def _inputs(n, c, l, dev):
    g = torch.Generator().manual_seed(n + c + l)
    f = torch.randn((n, c), generator=g).abs()
    w = torch.randn((c, l), generator=g) / c ** 0.5
    b = 0.1 * torch.randn((l,), generator=g)
    return f.to(dev), w.to(dev), b.to(dev)


def _codes(n, c, l, dev):
    g = torch.Generator().manual_seed(n)
    q = torch.randint(-127, 128, (n, l), generator=g, dtype=torch.int8).to(dev)
    s = (1e-3 + 0.1 * torch.rand((n, 1), generator=g)).to(dev)
    w = (torch.randn((l, c), generator=g) / l ** 0.5).to(dev)
    b = (0.1 * torch.randn((c,), generator=g)).to(dev)
    return q, s, w, b


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tile", list(tiles.TILES))
def test_compress_tile_matches_plain_and_every_tile(cuda, shape, tile):
    f, w, b = _inputs(*shape, cuda)
    qr, sr = ref.bottleneck_compress_ref(f, w, b)
    reset_launches()
    q, s = comp.bottleneck_compress(f, w, b, tile=tile)
    torch.cuda.synchronize()
    assert launch_counts()["bottleneck_compress"] == {t: int(t == tile) for t in tiles.TILES}
    assert int((q.int() - qr.int()).abs().max()) <= 1
    assert float(((s - sr).abs() / sr).max()) <= 1e-5
    for other in tiles.TILES:
        qo, so = comp.bottleneck_compress(f, w, b, tile=other)
        assert torch.equal(q, qo) and torch.equal(s, so), other


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tile", list(tiles.TILES))
def test_decompress_tile_matches_plain_and_every_tile(cuda, shape, tile):
    q, s, w, b = _codes(*shape, cuda)
    want = ref.bottleneck_decode_ref(q, s, w, b)
    reset_launches()
    got = bottleneck_decompress(q, s, w, b, tile=tile)
    torch.cuda.synchronize()
    assert launch_counts()["bottleneck_decompress"] == {t: int(t == tile) for t in tiles.TILES}
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    for other in tiles.TILES:
        assert torch.equal(got, bottleneck_decompress(q, s, w, b, tile=other)), other


def test_codec_on_views_off_the_16_byte_boundary(cuda):
    """Contiguous views whose rows start off a 16-byte boundary take the
    4-byte (f, w) and byte (q) copies, and give the same bits."""
    f, w, b = _inputs(40, 128, 64, cuda)
    flat = torch.zeros(f.numel() + 1, device=cuda)
    flat[1:] = f.reshape(-1)
    fv = flat[1:].view(f.shape)
    assert fv.is_contiguous() and fv.data_ptr() % 16 == 4
    assert all(torch.equal(a, b_) for a, b_ in zip(comp.bottleneck_compress(fv, w, b),
                                                   comp.bottleneck_compress(f, w, b)))
    q, s, wd, bd = _codes(40, 128, 64, cuda)
    flat8 = torch.zeros(q.numel() + 1, dtype=torch.int8, device=cuda)
    flat8[1:] = q.reshape(-1)
    qv = flat8[1:].view(q.shape)
    assert torch.equal(bottleneck_decompress(qv, s, wd, bd), bottleneck_decompress(q, s, wd, bd))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    f, w, b = _inputs(8, 16, 4, cuda)
    with pytest.raises(ValueError, match="unknown tile"):
        comp.bottleneck_compress(f, w, b, tile="rows")
    with pytest.raises(ValueError, match="unknown tile"):
        bottleneck_decompress(*_codes(8, 16, 4, cuda), tile="cols")
    with pytest.raises(ValueError, match="is on"):
        comp.bottleneck_compress(f, w.cpu(), b)



def _kernel_calls(dev):
    """Each wrapper at the smallest shapes its kernel takes: (call, inputs)."""
    g = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)
    q, s, wd, bd = _codes(8, 16, 4, dev)
    return {
        "bottleneck_compress": (comp.bottleneck_compress, list(_inputs(8, 16, 4, dev))),
        "bottleneck_decompress": (bottleneck_decompress, [q, s, wd, bd]),
        "flash_attention": (flash_attention, [randn(1, 16, 2, 128), randn(1, 16, 1, 128),
                                              randn(1, 16, 1, 128)]),
        "rwkv6_scan": (rwkv6_scan, [randn(1, 4, 2, 64), randn(1, 4, 2, 64), randn(1, 4, 2, 64),
                                    torch.full((1, 4, 2, 64), 0.9, device=dev),
                                    randn(2, 64), randn(1, 2, 64, 64)]),
        "mamba_scan": (mamba_scan, [0.1 * randn(1, 4, 8).abs(), randn(1, 4, 16), randn(1, 4, 16),
                                    randn(1, 4, 8), -randn(8, 16).abs(), randn(1, 8, 16)]),
    }


def _cotangents(outs, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(o.shape, generator=g).to(o.device, o.dtype) for o in outs]


def _plain_backward(name, inputs, outs, cots):
    """The plain backward of ``name`` at ``inputs``: the gradients of every
    input, given the kernel's outputs ``outs`` and their cotangents."""
    if name == "flash_attention":
        return ref.flash_attention_bwd_ref(*inputs, outs[0], cots[0], causal=True, window=None)
    if name == "mamba_scan":
        return ref.mamba_scan_bwd_ref(*inputs, *cots)
    return ref.rwkv6_scan_bwd_ref(*inputs, *cots)


def test_kernel_wrappers_refuse_inputs_that_require_grad(cuda):
    """A kernel with no backward returns a fresh tensor with no grad_fn: a
    gradient through it would come back as zero.  The codec wrappers raise
    instead, launching nothing, while grad mode is on and an input requires
    grad; under ``no_grad`` the same call launches.  ``flash_attention``,
    ``rwkv6_scan`` and ``mamba_scan`` have backward kernels: with any one
    input requiring grad they launch forward and backward once each, and the
    gradient equals the plain backward's."""
    for name, (call, inputs) in _kernel_calls(cuda).items():
        for i, t in enumerate(inputs):
            if not t.is_floating_point():
                continue
            args = [a.requires_grad_() if j == i else a for j, a in enumerate(
                [x.detach().clone() for x in inputs])]
            reset_launches()
            if name in ("flash_attention", "rwkv6_scan", "mamba_scan"):
                outs = call(*args)
                outs = outs if isinstance(outs, tuple) else (outs,)
                cots = _cotangents(outs)
                (got,) = torch.autograd.grad(outs, [args[i]], cots)
                torch.cuda.synchronize()
                counts = launch_counts()[name]
                assert sum(counts.values()) == 2 and min(
                    n for n in counts.values() if n) == 1, (name, i, counts)
                want = _plain_backward(name, [a.detach() for a in inputs],
                                       [o.detach() for o in outs], cots)[i]
                assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), (
                    name, i)
                continue
            with pytest.raises(RuntimeError, match="requires grad"):
                call(*args)
            assert sum(launch_counts()[name].values()) == 0, (name, i)
            with torch.no_grad():
                call(*args)
            torch.cuda.synchronize()
            assert sum(launch_counts()[name].values()) == 1, (name, i)


def test_split_runtime_on_the_card_matches_the_cpu_path(cuda):
    model = vgg_cifar(n_classes=8, input_hw=16, width_mult=0.25)
    params_cpu = model.init(0, device="cpu")
    params = [{k: v.to(cuda) for k, v in p.items()} for p in params_cpu]
    acts = model.activation_shapes(params_cpu, 1)
    ae_cpu = {c: B.init_bottleneck(c, acts[c][1:], 0.5, device="cpu") for c in (6, 9)}
    ae = {c: {p: {k: v.to(cuda) for k, v in d.items()} for p, d in a.items()}
          for c, a in ae_cpu.items()}
    x = np.random.default_rng(0).standard_normal((4, 16, 16, 3)).astype(np.float32)
    reset_launches()
    eager = SplitRuntime(model, params, (6, 9), ae=ae, device=cuda).infer(x, iters=1)
    fused = SplitRuntime(model, params, (6, 9), ae=ae, fused=True, device=cuda).infer(x, iters=1)
    counts = launch_counts()
    assert sum(counts["bottleneck_compress"].values()) > 0
    assert sum(counts["bottleneck_decompress"].values()) > 0
    np.testing.assert_array_equal(eager.logits, fused.logits)
    on_cpu = SplitRuntime(model, params_cpu, (6, 9), ae=ae_cpu, device="cpu").infer(x, iters=1)
    rel = np.abs(eager.logits - on_cpu.logits).max() / np.abs(on_cpu.logits).max()
    assert rel < 1e-3
    res, server = run_clients(model, params, 9, [x[:2], x[2:]], ae=ae[9], n_slots=2,
                              device=cuda)
    assert sorted(res) == [0, 1] and server.n_batches == 1


# b, sq, sk, h, kh, d, causal, window: ragged lengths, Sq < Sk, GQA, windows,
# and the head counts of llama3.2-3b (24 over 8) and jamba-v0.1-52b (32 over
# 8) at head dim 128; at head dim 64 the reference's D-64 cases
# (tests/test_kernels.py FLASH_CASES), ragged and windowed ones, and
# whisper-tiny's shapes (H 6): the encoder over 1500 frames and the
# cross-attention, Sq > Sk with no mask (also at D 128 and with GQA)
FLASH_SHAPES = [(2, 77, 77, 4, 2, 128, True, None), (1, 200, 200, 8, 2, 128, True, 64),
                (1, 50, 130, 4, 4, 128, True, None), (2, 33, 100, 2, 1, 128, False, 40),
                (1, 1, 1, 4, 2, 128, True, None), (1, 256, 256, 24, 8, 128, True, None),
                (1, 256, 256, 32, 8, 128, True, None),
                (2, 256, 256, 4, 2, 64, True, None), (2, 256, 256, 8, 2, 64, True, 128),
                (1, 256, 256, 2, 1, 64, False, None), (1, 256, 256, 4, 1, 64, True, None),
                (2, 77, 77, 4, 2, 64, True, None), (1, 50, 130, 6, 6, 64, True, 40),
                (1, 1500, 1500, 6, 6, 64, False, None), (2, 300, 150, 6, 6, 64, False, None),
                (1, 2000, 1500, 6, 6, 64, False, None), (1, 260, 130, 4, 2, 128, False, None),
                (2, 9, 1, 4, 2, 64, False, None),
                # GQA groups of 16 (qwen3-moe-235b-a22b: H 64 over K 4)
                (1, 256, 256, 16, 1, 128, True, None), (2, 200, 200, 64, 4, 128, True, None),
                # the f32 kernels' tile edges (kernels.flash_attention.f32_tiles: 64
                # rows a block, D keys or queries a tile): Sq and Sk at 64 and D, and
                # one off either way; a window of 1, windows across a tile edge;
                # unmasked Sq > Sk; GQA groups of 1 and 3
                (1, 63, 65, 3, 1, 64, True, None), (1, 65, 129, 2, 2, 128, True, None),
                (1, 64, 64, 6, 2, 64, True, 1), (1, 128, 128, 6, 2, 128, True, 1),
                (1, 129, 129, 3, 1, 64, True, 65), (1, 127, 128, 4, 4, 128, True, 129),
                (1, 129, 127, 3, 1, 128, False, None), (2, 65, 63, 6, 2, 64, False, None),
                (1, 128, 129, 2, 2, 128, False, 64)]
# beside the absolute bf16 bar, element by element, one relative to |o|: the
# kernel rounds each softmax weight and each output to bf16, at most 2**-8
# of the value each, so |kernel - plain| <= 2**-8 (|o| + P|V|), P|V| the
# plain attention over |v|; the bar allows twice that, one bf16 step of o
BF16_STEP = 2.0 ** -7


def _step_share(got, want, q, k, v, causal, window):
    """The largest share of the bf16 step bar that |got - want| takes."""
    spread = ref.flash_attention_ref(q, k, v.abs(), causal=causal, window=window).float()
    bar = BF16_STEP * (want.float().abs() + spread)
    return float(((got.float() - want.float()).abs() / bar).max())


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_plain(cuda, shape, dtype):
    b, sq, sk, h, kh, d, causal, window = shape
    g = torch.Generator().manual_seed(sq * sk + d)
    dt = getattr(torch, dtype)
    q = torch.randn((b, sq, h, d), generator=g).to(cuda, dt)
    k, v = (torch.randn((b, sk, kh, d), generator=g).to(cuda, dt) for _ in range(2))
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    reset_launches()
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == {r: int(r == ROUTES[dt])
                                                  for r in launch_counts()["flash_attention"]}
    assert got.dtype == dt and got.shape == q.shape
    # as tests/test_kernels.py holds the TPU kernel to its ref
    assert float((got.float() - want.float()).abs().max()) <= (2e-5 if dtype == "float32"
                                                               else 2e-2)
    if dt == torch.bfloat16:
        assert _step_share(got, want, q, k, v, causal, window) <= 1


# the mask-edge probe (ref.flash_edge_probe) at each mask: causal, window,
# Sq < Sk, ragged, non-causal, at head dims 128 and 64 (and Sq > Sk with no
# mask); rising scores find the causal or key-range edge, falling ones the
# window's: (b, sq, sk, h, kh, d, causal, window)
PROBE_SHAPES = [(1, 300, 300, 4, 2, 128, True, None), (1, 300, 300, 4, 2, 128, True, 64),
                (2, 100, 333, 8, 2, 128, True, 130), (1, 77, 77, 4, 4, 128, True, None),
                (1, 200, 200, 4, 2, 128, False, None), (1, 200, 200, 4, 2, 128, False, 50),
                (1, 300, 300, 6, 6, 64, True, 64), (2, 100, 333, 6, 6, 64, True, 130),
                (1, 300, 200, 6, 6, 64, False, None)]


@pytest.mark.parametrize("shape", PROBE_SHAPES)
@pytest.mark.parametrize("rising", [True, False])
def test_flash_attention_bf16_mask_edges(cuda, shape, rising):
    b, sq, sk, h, kh, d, causal, window = shape
    q, k, v = ref.flash_edge_probe(b, sq, sk, h, kh, d, rising=rising, seed=sq,
                                   device=cuda)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= 2e-2
    assert _step_share(got, want, q, k, v, causal, window) <= 1


def _grad_gap(got, want, scales=None):
    """Max |got - want| of each gradient over its max |want| (or over
    ``scales``)."""
    scales = scales or [float(b.float().abs().max()) for b in want]
    return [float((a.float() - b.float()).abs().max()) / sc
            for a, b, sc in zip(got, want, scales)]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_backward_matches_plain(cuda, shape, dtype):
    """dq, dk, dv through the autograd path (the backward kernels) against
    ``flash_attention_bwd_ref`` on the kernel's own output, and the plain
    forward's autograd gradients: f32 within 1e-4 of each gradient's max,
    bf16 within 2e-2 (the kernel's forward rounds the weights to bf16)."""
    b, sq, sk, h, kh, d, causal, window = shape
    g = torch.Generator().manual_seed(sq * sk + d + 1)
    dt = getattr(torch, dtype)
    q = torch.randn((b, sq, h, d), generator=g).to(cuda, dt).requires_grad_()
    k, v = (torch.randn((b, sk, kh, d), generator=g).to(cuda, dt).requires_grad_()
            for _ in range(2))
    do = torch.randn((b, sq, h, d), generator=g).to(cuda, dt)
    reset_launches()
    out = flash_attention(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    counts = launch_counts()["flash_attention"]
    assert counts[ROUTES[dt]] == 1 and counts["bwd_" + ("f32" if dtype == "float32"
                                                         else "bf16")] == 1
    assert all(a.dtype == dt and a.shape == t.shape for a, t in zip(got, (q, k, v)))
    bar = 1e-4 if dtype == "float32" else 2e-2
    want = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), out.detach(), do,
                                       causal=causal, window=window)
    scales = [float(w.float().abs().max()) for w in want]
    if sk == 1 or window == 1:
        # one key a row: the softmax is constant, so dq and dk are 0 in exact
        # arithmetic and rounding noise on both sides; held at dv's scale
        scales = [scales[2]] * 3
    assert max(_grad_gap(got, want, scales)) <= bar
    q0, k0, v0 = (t.detach().requires_grad_() for t in (q, k, v))
    plain = torch.autograd.grad(ref.flash_attention_ref(q0, k0, v0, causal=causal,
                                                        window=window), (q0, k0, v0), do)
    assert max(_grad_gap(got, plain, scales)) <= bar


# the forward's row log-sum-exp against ref.flash_attention_lse_ref,
# absolute, as chip_smoke.FLASH_LSE_BAR: f32 sums in another order; in bf16
# also the scores summed on the tensor cores, the softmax in base 2 and lse
# taken back to base e
LSE_BAR = {"float32": 1e-5, "bfloat16": 1e-5}


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_lse_matches_plain(cuda, shape, dtype):
    """The training route's forward: its output bit for bit the serving
    route's (the kernel writes lse only when asked), and each row's lse
    within ``LSE_BAR`` of the plain one."""
    b, sq, sk, h, kh, d, causal, window = shape
    g = torch.Generator().manual_seed(sq * sk + d + 2)
    dt = getattr(torch, dtype)
    q = torch.randn((b, sq, h, d), generator=g).to(cuda, dt)
    k, v = (torch.randn((b, sk, kh, d), generator=g).to(cuda, dt) for _ in range(2))
    reset_launches()
    out, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
    plain = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"][ROUTES[dt]] == 2
    assert torch.equal(out, plain)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    want = ref.flash_attention_lse_ref(q, k, causal=causal, window=window)
    assert float((lse - want).abs().max()) <= LSE_BAR[dtype]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_backward_is_deterministic(cuda, shape, dtype):
    """No atomics: two calls of the direct backward give equal bits."""
    b, sq, sk, h, kh, d, causal, window = shape
    g = torch.Generator().manual_seed(sq * sk + d + 3)
    dt = getattr(torch, dtype)
    q = torch.randn((b, sq, h, d), generator=g).to(cuda, dt)
    k, v = (torch.randn((b, sk, kh, d), generator=g).to(cuda, dt) for _ in range(2))
    do = torch.randn((b, sq, h, d), generator=g).to(cuda, dt)
    o, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
    first = flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
    second = flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))


def test_flash_attention_bwd_refuses_a_missing_lse_and_a_misaligned_do(cuda):
    q = torch.zeros((1, 8, 4, 128), dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros((1, 8, 2, 128), dtype=torch.bfloat16, device=cuda)
    o, lse = flash_attention_lse(q, kv, kv)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, kv, kv, o, q.clone(), None)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    do = flat[1:].view(q.shape)               # contiguous, 2 bytes off the boundary
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention_bwd(q, kv, kv, o, do, lse)


def test_flash_attention_refuses_other_head_dims_and_masked_sq_above_sk(cuda):
    q, kv = torch.zeros((1, 8, 4, 32), device=cuda), torch.zeros((1, 8, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, kv, kv)
    q, kv = torch.zeros((1, 9, 4, 64), device=cuda), torch.zeros((1, 8, 2, 64), device=cuda)
    for kw in ({"causal": True}, {"causal": False, "window": 4}):
        with pytest.raises(ValueError, match="Sq 9 > Sk 8"):
            flash_attention(q, kv, kv, **kw)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_no_flash_kernel_spills(cuda, dtype, d):
    """Every flash kernel of a dtype and head dim keeps its registers
    (``cudaFuncGetAttributes``: no local bytes); the f32 kernels' tiles are
    ``f32_tiles``."""
    dt = getattr(torch, dtype)
    fwd, bwd = kernel_info(dt, d), bwd_kernel_info(dt, d)
    for name, attrs in {**fwd["kernels"], **bwd["kernels"]}.items():
        assert attrs["local_bytes"] == 0, (name, attrs)
        assert 0 < attrs["registers"] <= 255, (name, attrs)
    if dt == torch.float32:
        table = f32_tiles(d)
        assert fwd["tiles"] == table["fwd"]
        assert bwd["tiles"] == {"dkdv_keys": table["dkdv"]["keys"],
                                "dkdv_queries": table["dkdv"]["queries"],
                                "dq_queries": table["dq"]["queries"], "dq_keys": table["dq"]["keys"]}
        # 16 resident warps an SM: at most 128 registers a thread
        assert all(a["registers"] <= 128 for a in {**fwd["kernels"], **bwd["kernels"]}.values())


def test_flash_attention_f32_takes_a_view_off_the_16_byte_boundary(cuda):
    """The f32 kernels copy in 16 bytes: the wrapper copies a view that
    does not start on a 16-byte boundary, and the results are the aligned
    call's, bit for bit."""
    g = torch.Generator().manual_seed(5)
    q = torch.randn((1, 70, 4, 64), generator=g).to(cuda)
    k, v = (torch.randn((1, 70, 2, 64), generator=g).to(cuda) for _ in range(2))
    do = torch.randn((1, 70, 4, 64), generator=g).to(cuda)
    flat = torch.zeros(k.numel() + 1, device=cuda)
    k_off = flat[1:].view(k.shape)
    k_off.copy_(k)
    assert k_off.data_ptr() % 16 == 4
    want, lse = flash_attention_lse(q, k, v)
    got, lse_off = flash_attention_lse(q, k_off, v)
    assert torch.equal(got, want) and torch.equal(lse_off, lse)
    grads = flash_attention_bwd(q, k, v, want, do, lse)
    grads_off = flash_attention_bwd(q, k_off, v, want, do, lse)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_off))


def test_flash_attention_refuses_a_misaligned_bf16_view(cuda):
    q = torch.zeros((1, 8, 4, 128), dtype=torch.bfloat16, device=cuda)
    flat = torch.zeros(8 * 2 * 128 + 1, dtype=torch.bfloat16, device=cuda)
    k = flat[1:].view(1, 8, 2, 128)            # contiguous, 2 bytes off the boundary
    assert k.is_contiguous() and k.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention(q, k, k.clone())


# b, s, h, d, served decays: one step, ragged S; S 53, three of the kernel's
# 16-step ring stages and a tail of 5; S 64, four whole stages; the served
# model's decays, w = exp(-exp(-4 + 0.5 N(0, 1))) near 0.98 with u = 0.1
# N(0, 1) (models/rwkv.py), where the state sums some 50 steps.  A block
# holds a whole head, so no H leaves a partial group of columns.  The kernel
# takes rwkv6-1.6b's head dim, 64.
@pytest.mark.parametrize("shape", [(2, 1, 3, 64, False), (1, 37, 2, 64, False),
                                   (2, 300, 4, 64, False), (1, 5, 2, 64, False),
                                   (2, 53, 3, 64, False), (1, 64, 5, 64, False),
                                   (2, 300, 4, 64, True)])
def test_rwkv6_scan_matches_plain(cuda, shape):
    b, s, h, d, served_w = shape
    g = torch.Generator().manual_seed(s + d)
    r, k, v = (0.5 * torch.randn((b, s, h, d), generator=g) for _ in range(3))
    if served_w:
        w = torch.exp(-torch.exp(-4.0 + 0.5 * torch.randn((b, s, h, d), generator=g)))
        u = 0.1 * torch.randn((h, d), generator=g)
    else:
        w = torch.sigmoid(torch.randn((b, s, h, d), generator=g))
        u = 0.3 * torch.randn((h, d), generator=g)
    st = 0.2 * torch.randn((b, h, d, d), generator=g)
    args = [a.to(cuda) for a in (r, k, v, w, u, st)]
    want_out, want_st = ref.rwkv6_scan_ref(*args)
    reset_launches()
    out, final = rwkv6_scan(*args)
    torch.cuda.synchronize()
    assert launch_counts()["rwkv6_scan"]["chain"] == 1
    # as chip_smoke.py holds it: f32 in another summation order
    assert float((out - want_out).abs().max()) <= 1e-4 * float(want_out.abs().max())
    assert float((final - want_st).abs().max()) <= 1e-4 * float(want_st.abs().max())


# steps a chunk of the rwkv6_scan backward (csrc/rwkv6_scan_bwd.cu), as built
RWKV_BWD_T = int(re.search(r"constexpr int T = (\d+);", (
    Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
    / "rwkv6_scan_bwd.cu").read_text()).group(1))


def _rwkv_bwd_inputs(b, s, h, d, decays):
    """r, k, v, w, u, state, dout, dstate on the CPU; ``decays``: sigmoid(N),
    the served model's (about 0.98), or exp(-exp(N + 1)), whose products
    over a chunk underflow f32 to 0."""
    g = torch.Generator().manual_seed(s + d + 2)
    r, k, v = (0.5 * torch.randn((b, s, h, d), generator=g) for _ in range(3))
    if decays == "served":
        w = torch.exp(-torch.exp(-4.0 + 0.5 * torch.randn((b, s, h, d), generator=g)))
        u = 0.1 * torch.randn((h, d), generator=g)
    elif decays == "underflow":
        w = torch.exp(-torch.exp(1.0 + torch.randn((b, s, h, d), generator=g)))
        u = 0.3 * torch.randn((h, d), generator=g)
    else:
        w = torch.sigmoid(torch.randn((b, s, h, d), generator=g))
        u = 0.3 * torch.randn((h, d), generator=g)
    st = 0.2 * torch.randn((b, h, d, d), generator=g)
    dout, dst = torch.randn((b, s, h, d), generator=g), torch.randn((b, h, d, d), generator=g)
    return r, k, v, w, u, st, dout, dst


# (b, s, h, d, decays): S 1, S 16, ragged S, the served decays; then B H 1 on
# either side of the kernel's chunk edge and over two chunks and a tail, the
# last with decays whose products over a chunk underflow
@pytest.mark.parametrize("shape", [(2, 1, 3, 64, "sigmoid"), (1, 37, 2, 64, "sigmoid"),
                                   (2, 300, 4, 64, "sigmoid"), (1, 16, 2, 64, "sigmoid"),
                                   (2, 53, 3, 64, "sigmoid"), (2, 300, 4, 64, "served"),
                                   (1, RWKV_BWD_T - 1, 1, 64, "sigmoid"),
                                   (1, RWKV_BWD_T, 1, 64, "sigmoid"),
                                   (1, RWKV_BWD_T + 1, 1, 64, "sigmoid"),
                                   (1, 2 * RWKV_BWD_T + 3, 1, 64, "underflow")])
def test_rwkv6_scan_backward_matches_plain(cuda, shape):
    """The gradients of r, k, v, w, u and the start state through the
    autograd path (the backward kernels), from a nonzero start state and
    nonzero gradients of out and of the final state, against
    ``rwkv6_scan_bwd_ref`` and the plain scan's autograd gradients, each
    within 1e-4 of its max (f32 in another summation order)."""
    b, s, h, d, decays = shape
    r, k, v, w, u, st, dout, dst = _rwkv_bwd_inputs(b, s, h, d, decays)
    if decays == "underflow":
        assert float(w[:, :RWKV_BWD_T].prod(1).min()) == 0.0
    args = [a.to(cuda).requires_grad_() for a in (r, k, v, w, u, st)]
    dout, dst = dout.to(cuda), dst.to(cuda)
    reset_launches()
    out, final = rwkv6_scan(*args)
    got = torch.autograd.grad((out, final), args, (dout, dst))
    torch.cuda.synchronize()
    assert launch_counts()["rwkv6_scan"] == {"chain": 1, "bwd": 1}
    want = ref.rwkv6_scan_bwd_ref(*(a.detach() for a in args), dout, dst)
    assert max(_grad_gap(got, want)) <= 1e-4
    plain_args = [a.detach().requires_grad_() for a in args]
    plain = torch.autograd.grad(ref.rwkv6_scan_ref(*plain_args), plain_args, (dout, dst))
    assert max(_grad_gap(got, plain)) <= 1e-4


def test_rwkv6_scan_backward_gives_the_same_bits_twice(cuda):
    """Every sum of the backward is in a fixed order: two calls agree bit
    for bit, over several chunks at the served and the underflowing decays."""
    for decays in ("served", "underflow"):
        ins = [t.to(cuda) for t in _rwkv_bwd_inputs(2, 3 * RWKV_BWD_T + 7, 3, 64, decays)]
        first = rwkv6_scan_bwd(*ins)
        again = rwkv6_scan_bwd(*ins)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_rwkv6_scan_backward_workspace(cuda):
    """The scratch is each chunk's boundary state and gradient, its rows'
    decay product and its partial of du, 2 B H nc D (D + 1) floats, and at
    rwkv6-1.6b's training shape (B 1, S 4096, H 32) under 150 MB."""
    for b, s, h in ((1, 1, 1), (2, RWKV_BWD_T + 1, 3), (4, 1000, 32), (1, 4096, 32)):
        nc = -(-s // RWKV_BWD_T)
        assert bwd_workspace(b, s, h) == 2 * b * h * nc * 64 * 65
    assert 4 * bwd_workspace(1, 4096, 32) < 150e6


def test_rwkv6_scan_refuses_a_view_off_the_16_byte_boundary(cuda):
    r = torch.zeros((1, 4, 2, 64), device=cuda)
    flat = torch.zeros(r.numel() + 1, device=cuda)
    k = flat[1:].view(r.shape)                 # contiguous, 4 bytes off the boundary
    assert k.is_contiguous() and k.data_ptr() % 16 == 4
    u, st = torch.zeros((2, 64), device=cuda), torch.zeros((1, 2, 64, 64), device=cuda)
    with pytest.raises(ValueError, match="16-byte boundary"):
        rwkv6_scan(r, k, r, r, u, st)


# b, s, di, served A: one step, ragged S and di (not a whole block of
# channels); S 35 ends on a partial stage of the kernel's ring (two stages
# of 16 steps and 3); S 1 at a di that is no multiple of 4 (the kernel's
# 4-byte copies); the served model's own A, -(1 .. 16) in every channel
# (models/mamba.py), with dt = softplus(N(0, 1)), where |dt A| reaches
# 10-20.  The kernel takes jamba's d_state, 16.
@pytest.mark.parametrize("shape", [(2, 1, 256, False), (1, 37, 300, False), (2, 300, 512, False),
                                   (3, 70, 8192, False), (2, 35, 512, False),
                                   (3, 1, 333, False), (2, 300, 1000, True)])
def test_mamba_scan_matches_plain(cuda, shape):
    b, s, di, served_a = shape
    g = torch.Generator().manual_seed(s + di)
    dt = (1.0 if served_a else 0.1) * torch.nn.functional.softplus(
        torch.randn((b, s, di), generator=g))
    bm, cm = (0.5 * torch.randn((b, s, 16), generator=g) for _ in range(2))
    x = torch.randn((b, s, di), generator=g)
    if served_a:
        a = -torch.arange(1, 17, dtype=torch.float32).expand(di, 16).contiguous()
    else:
        a = -torch.exp(0.3 * torch.randn((di, 16), generator=g))
    st = 0.3 * torch.randn((b, di, 16), generator=g)
    args = [t.to(cuda) for t in (dt, bm, cm, x, a, st)]
    want_y, want_st = ref.mamba_scan_ref(*args)
    reset_launches()
    y, final = mamba_scan(*args)
    torch.cuda.synchronize()
    assert launch_counts()["mamba_scan"]["chain"] == 1
    # as chip_smoke.py holds it: f32 in another summation order
    assert float((y - want_y).abs().max()) <= 1e-5 * float(want_y.abs().max())
    assert float((final - want_st).abs().max()) <= 1e-5 * float(want_st.abs().max())


MAMBA_BWD_T = int(re.search(r"constexpr int T = (\d+);", (
    Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
    / "mamba_scan_bwd.cu").read_text()).group(1))


def _mamba_bwd_inputs(b, s, di, served_a):
    """dt, b, c, x, a, state, dy, dstate on the CPU, as chip_smoke.py's Z7b
    draws them."""
    g = torch.Generator().manual_seed(s + di + 5)
    dt = (1.0 if served_a else 0.1) * torch.nn.functional.softplus(
        torch.randn((b, s, di), generator=g))
    bm, cm = (0.5 * torch.randn((b, s, 16), generator=g) for _ in range(2))
    x = torch.randn((b, s, di), generator=g)
    if served_a:
        a = -torch.arange(1, 17, dtype=torch.float32).expand(di, 16).contiguous()
    else:
        a = -torch.exp(0.3 * torch.randn((di, 16), generator=g))
    st = 0.3 * torch.randn((b, di, 16), generator=g)
    dy, dst = torch.randn((b, s, di), generator=g), torch.randn((b, di, 16), generator=g)
    return dt, bm, cm, x, a, st, dy, dst


# b, s, di, served A: S 1; either side of the kernel's chunk edge and two
# chunks and a tail; di not a multiple of a block's 64 channels, and not of 4
# (the 4-byte copies); the served model's own A, where |dt A| reaches 10-20
@pytest.mark.parametrize("shape", [(2, 1, 256, False), (1, MAMBA_BWD_T - 1, 64, False),
                                   (1, MAMBA_BWD_T, 100, False), (2, MAMBA_BWD_T + 1, 70, True),
                                   (2, 2 * MAMBA_BWD_T + 5, 333, False), (3, 300, 1000, True),
                                   (1, 513, 8192, False)])
def test_mamba_scan_backward_matches_plain(cuda, shape):
    """The gradients of dt, B, C, x, A and the start state through the
    autograd path (the backward kernels), from a nonzero start state and
    nonzero gradients of y and of the final state, against
    ``mamba_scan_bwd_ref`` and the plain scan's autograd gradients, each
    within 1e-4 of its max (f32 in another summation order); two calls of
    the backward agree bit for bit."""
    ins = [t.to(cuda) for t in _mamba_bwd_inputs(*shape)]
    args = [a.clone().requires_grad_() for a in ins[:6]]
    reset_launches()
    y, final = mamba_scan(*args)
    got = torch.autograd.grad((y, final), args, tuple(ins[6:]))
    torch.cuda.synchronize()
    assert launch_counts()["mamba_scan"] == {"chain": 1, "bwd": 1}
    want = ref.mamba_scan_bwd_ref(*ins)
    assert max(_grad_gap(got, want)) <= 1e-4
    plain_args = [a.detach().requires_grad_() for a in args]
    plain = torch.autograd.grad(ref.mamba_scan_ref(*plain_args), plain_args, tuple(ins[6:]))
    assert max(_grad_gap(got, plain)) <= 1e-4
    again = mamba_scan_bwd(*ins)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_mamba_scan_backward_spills_nothing_and_fills_the_card(cuda):
    """No kernel of the backward spills, and the chunk kernel keeps 16 warps
    an SM."""
    info = MS.bwd_kernel_info()
    assert not any(k["local_bytes"] for k in info["kernels"].values()), info
    assert info["kernels"]["mamba_bwd_chunk"]["warps_per_sm"] >= 16, info


@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-1.6b", "jamba-v0.1-52b",
                                  "deepseek-moe-16b", "whisper-tiny", "internvl2-76b",
                                  "qwen3-moe-235b-a22b"])
def test_zoo_serving_on_the_card_matches_the_cpu_path(cuda, arch):
    import dataclasses
    # the head dims the kernels take, each config's own: 128, or 64 (whisper's
    # attention, rwkv's scan)
    cfg = dataclasses.replace(reduced(get_config(arch), head_dim=get_config(arch).hd,
                                      rwkv_head_dim=64),
                              dtype="float32", **SERVED.get(arch, {}))
    params_cpu = T.init_params(0, cfg, device="cpu")
    params = _to(params_cpu, cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (5, 70, 9)]
    reset_launches()
    got = ServingEngine(cfg, params, cache_slots=80, device=cuda).run(
        [Request(i, p, max_new=4) for i, p in enumerate(prompts)])
    counts = launch_counts()
    kernels = {"llama3.2-3b": ["flash_attention"], "rwkv6-1.6b": ["rwkv6_scan"],
               "jamba-v0.1-52b": ["flash_attention", "mamba_scan"],
               "deepseek-moe-16b": ["flash_attention"], "whisper-tiny": ["flash_attention"],
               "internvl2-76b": ["flash_attention"],
               "qwen3-moe-235b-a22b": ["flash_attention"]}[arch]
    assert all(sum(counts[k].values()) > 0 for k in kernels)
    want = ServingEngine(cfg, params_cpu, cache_slots=80, device="cpu").run(
        [Request(i, p, max_new=4) for i, p in enumerate(prompts)])
    assert [r.out for r in got] == [r.out for r in want]


@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-1.6b", "deepseek-moe-16b"])
def test_continuous_batcher_on_the_card_matches_the_cpu_path(cuda, arch):
    """Staggered arrivals on 3 slots, slots refilled mid-decode: the same
    tokens on the card (its kernels at each admit, and rwkv's scan at each
    tick) as on the CPU."""
    import dataclasses
    from repro_torch.serving.continuous import ContinuousBatcher, StreamRequest
    cfg = dataclasses.replace(reduced(get_config(arch), head_dim=get_config(arch).hd,
                                      rwkv_head_dim=64), dtype="float32")
    params_cpu = T.init_params(0, cfg, device="cpu")
    params = _to(params_cpu, cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (9, 1, 40, 4, 17)]

    def run(p, dev):
        reqs = [StreamRequest(i, x, max_new=m, arrival=a)
                for i, (x, m, a) in enumerate(zip(prompts, (5, 2, 6, 3, 4), (0, 0, 0, 1, 3)))]
        ContinuousBatcher(cfg, p, n_slots=3, cache_len=48, device=dev).run(reqs)
        return [r.out for r in reqs]
    reset_launches()
    got = run(params, cuda)
    counts = launch_counts()
    kernel = "rwkv6_scan" if arch == "rwkv6-1.6b" else "flash_attention"
    assert sum(counts[kernel].values()) > 0
    assert got == run(params_cpu, "cpu")


def test_init_params_holds_the_model_once(cuda):
    """Building the group-stacked tree on the card peaks near the model's own
    size: each group's leaves are freed as they are stacked (it peaked at
    twice the model before, 72 GB for jamba with moe=None in f32)."""
    import dataclasses
    cfg = dataclasses.replace(reduced(get_config("llama3.2-3b")), n_layers=16, dtype="float32")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = T.init_params(0, cfg, device=cuda)
    peak = torch.cuda.max_memory_allocated() - base
    size = sum(t.numel() * t.element_size() for t in _leaves(params))
    assert peak < 1.5 * size, (peak, size)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _paths(tree, path=()):
    """(key path, leaf) of a nest of dicts, in ``_leaves``' order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path, tree


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _train_batch(cfg, dev, b=2, s=40, seed=0):
    """tokens and labels (numpy seed ``seed``) and the stub frontend's
    N(0, 1) frames or patches, on ``dev``."""
    rng = np.random.default_rng(seed)
    st = s - (cfg.n_patches if cfg.family == "vlm" else 0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, st)).astype(np.int32)).to(dev)
             for k in ("tokens", "labels")}
    if cfg.family in ("vlm", "encdec"):
        key, n = (("frames", cfg.n_frames) if cfg.family == "encdec"
                  else ("patch_embeds", cfg.n_patches))
        batch[key] = torch.from_numpy(
            rng.standard_normal((b, n, cfg.d_frontend)).astype(np.float32)).to(dev, cfg.tdtype)
    return batch


def _loss_and_grads(params, cfg, batch):
    live = [p.detach().requires_grad_() for p in _leaves(params)]
    it = iter(live)
    loss, _ = T.loss_fn(tree_map(lambda _: next(it), params), cfg, batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]


# the families whose layers all have backward kernels on the card: dense,
# moe, ssm, encdec and vlm, at the head dims the kernels take
@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-moe-16b", "rwkv6-1.6b",
                                  "whisper-tiny", "internvl2-76b"])
def test_zoo_train_step_on_the_card_matches_the_cpu_path(cuda, arch):
    """The loss and every gradient of a reduced f32 model through the
    kernels (each attention layer's forward launched twice: once more when
    its group is recomputed in the backward) against the plain versions on
    the CPU: the loss within 1e-5 relative, each gradient within 1e-4 of
    its leaf's max; then a ``make_train_step`` step on each, their next
    losses within 1e-5."""
    import dataclasses
    from repro_torch.training.optimizer import OptConfig, adamw_init
    from repro_torch.training.train import make_train_step
    cfg = dataclasses.replace(reduced(get_config(arch), head_dim=get_config(arch).hd,
                                      rwkv_head_dim=64), dtype="float32")
    params_cpu = T.init_params(0, cfg, device="cpu")
    params = _to(params_cpu, cuda)
    batch_cpu, batch = _train_batch(cfg, "cpu"), _train_batch(cfg, cuda)
    reset_launches()
    loss, grads = _loss_and_grads(params, cfg, batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    kernel = "rwkv6_scan" if arch == "rwkv6-1.6b" else "flash_attention"
    fwd, bwd = (("chain", "bwd") if kernel == "rwkv6_scan" else ("simt_f32", "bwd_f32"))
    assert counts[kernel][bwd] > 0 and counts[kernel][fwd] == 2 * counts[kernel][bwd]
    want_loss, want = _loss_and_grads(params_cpu, cfg, batch_cpu)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    paths = [path for path, _ in _paths(params_cpu)]
    by_path = dict(zip(paths, want))
    for path, g, w in zip(paths, grads, want):
        top = float(w.abs().max())
        if path[-1] == "bk":
            # softmax ignores a shift common to a query's scores: a key
            # bias's gradient is 0 in exact arithmetic, rounding noise on
            # both sides, held at the scale of its wk's gradient
            top = max(top, float(by_path[path[:-1] + ("wk",)].abs().max()))
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * top, path
    oc = OptConfig(lr=1e-3)
    step = make_train_step(cfg, oc)
    losses = []
    for p, b in ((params, batch), (params_cpu, batch_cpu)):
        state = adamw_init(p, oc)
        p, state, _ = step(p, state, b)
        _, state, metrics = step(p, state, b)
        losses.append(float(metrics["loss"]))
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])


def test_hybrid_train_step_on_the_card_matches_the_cpu_path(cuda):
    """jamba (``moe=None``, one 8-layer period: 7 Mamba mixers and one
    attention layer, reduced width at head dim 128) as the test above holds
    the other families: the loss and every gradient through the kernels
    (each forward launched twice under the recompute, each backward once)
    against the plain versions on the CPU, then a ``make_train_step`` step."""
    import dataclasses
    from repro_torch.training.optimizer import OptConfig, adamw_init
    from repro_torch.training.train import make_train_step
    arch = "jamba-v0.1-52b"
    cfg = dataclasses.replace(reduced(get_config(arch), head_dim=get_config(arch).hd),
                              dtype="float32", **SERVED[arch])
    assert T.block_structure(cfg)[0][0].mixer == "mamba"
    params_cpu = T.init_params(0, cfg, device="cpu")
    params = _to(params_cpu, cuda)
    batch_cpu, batch = _train_batch(cfg, "cpu"), _train_batch(cfg, cuda)
    reset_launches()
    loss, grads = _loss_and_grads(params, cfg, batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["mamba_scan"] == {"chain": 14, "bwd": 7}, counts
    assert counts["flash_attention"]["simt_f32"] == 2 and counts["flash_attention"]["bwd_f32"] == 1
    want_loss, want = _loss_and_grads(params_cpu, cfg, batch_cpu)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    paths = [path for path, _ in _paths(params_cpu)]
    by_path = dict(zip(paths, want))
    for path, g, w in zip(paths, grads, want):
        top = float(w.abs().max())
        if path[-1] == "bk":
            top = max(top, float(by_path[path[:-1] + ("wk",)].abs().max()))
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * top, path
    oc = OptConfig(lr=1e-3)
    step = make_train_step(cfg, oc)
    losses = []
    for p, b in ((params, batch), (params_cpu, batch_cpu)):
        state = adamw_init(p, oc)
        p, state, _ = step(p, state, b)
        _, state, metrics = step(p, state, b)
        losses.append(float(metrics["loss"]))
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])


# the multi-pod pipeline's card route: llama3-8b narrowed to the kernels'
# head dim 128, bf16, 4 layers, B 8 of 256 tokens in 4 microbatches
PIPELINE_CFG = dict(n_layers=4, d_model=512, n_heads=4, n_kv_heads=2, head_dim=128, d_ff=1024)
PIPELINE_MODES = ("raw", "ae_f32", "ae_int8")


def _nccl_pipeline_rank(rank, world, tmp):
    """One pod on card ``rank``: the same seeded weights drawn on each card,
    the pipeline over nccl in each wire mode, and on the tail the
    sequential composition on its own card."""
    dev = LM.start_process_group("nccl", rank, world, f"file://{tmp}/rdv", device=f"cuda:{rank}",
                                 timeout_s=240)
    try:
        cfg = reduced(get_config("llama3-8b"), **PIPELINE_CFG)
        params = T.init_params(0, cfg, device=dev)
        ae = B.init_bottleneck(2, (cfg.d_model,), 0.5, device=dev)
        rng = np.random.default_rng(1)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 256)).astype(np.int32)).to(dev)
        mesh = LM.make_mesh_compat((2,), ("pod",))
        stage = mesh.get_local_rank("pod")
        out = {"stage": stage}
        for mode in PIPELINE_MODES:
            kw = dict(ae=None if mode == "raw" else ae, n_micro=4, quantize_wire=mode == "ae_int8")
            reset_launches()
            logits = SP.multipod_split_step(SP.stage_params(params, cfg, stage), cfg,
                                            {"tokens": tokens}, mesh, **kw)
            torch.cuda.synchronize()
            row = {"launches": launch_counts(), "bytes": SP.multipod_split_step.wire_bytes[mode],
                   "returned": logits is not None}
            if logits is not None:
                want = SP.sequential_split_step(params, cfg, {"tokens": tokens}, **kw)
                row["equal"] = bool(torch.equal(logits, want))
            out[mode] = row
    finally:
        torch.distributed.destroy_process_group()
    return out


def test_multipod_pipeline_over_nccl_across_two_cards(cuda, tmp_path):
    """Each pod on a card of its own, the wire from card to card: the tail's
    logits equal the sequential composition's bit for bit in every mode,
    the head sends the wire's bytes, and each pod launches its kernels."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: nccl puts each pod on a card of its own")
    ranks = {r["stage"]: r for r in LM.spawn_ranks(_nccl_pipeline_rank, 2, (str(tmp_path),),
                                                   timeout_s=300)}
    tokens, latent = 8 * 256, PIPELINE_CFG["d_model"] // 2
    sent = {"raw": tokens * PIPELINE_CFG["d_model"] * 2, "ae_f32": tokens * latent * 4,
            "ae_int8": tokens * latent + tokens * 4}
    for mode in PIPELINE_MODES:
        head, tail = ranks[0][mode], ranks[1][mode]
        assert (head["bytes"], tail["bytes"]) == (sent[mode], 0), mode
        assert not head["returned"] and tail["equal"], mode
        for row in (head, tail):
            assert row["launches"]["flash_attention"]["wgmma_bf16"] == 2 * 4, mode
        codec = 4 * (mode == "ae_int8")
        assert sum(head["launches"]["bottleneck_compress"].values()) == codec, mode
        assert sum(tail["launches"]["bottleneck_decompress"].values()) == codec, mode


# the sharded train step over nccl (ROADMAP A14b): depth-2 f32 llama3.2-3b at
# full width, B 4 x S 512, on two cards at ("data", "model") = (1, 2) and
# (2, 1), held to the one-card step at chip_smoke.py Z27's f32 bars (each
# loss within 1e-6 relative, m after step 1 within 1e-5 of each leaf's max,
# m and v after step 2 within 1e-4, each parameter within 2 lr a step plus
# one ulp a step); jamba-v0.1-52b (moe=None) whole on four cards, B 4 x S
# 4096, its losses finite and falling, step 1's within 1e-2 of a one-card
# loss_fn under no_grad
SHARDED_STEPS = 2
SHARDED_LOSS_RTOL = 1e-6
SHARDED_MOMENT = {"m1": 1e-5, "m2": 1e-4, "v2": 1e-4}
JAMBA_LOSS_RTOL = 1e-2


def _sharded_setup(arch, changes, b, s, dev):
    from repro_torch.data.synthetic import token_batch
    cfg = dataclasses.replace(get_config(arch), **{**SERVED.get(arch, {}), **changes})
    batch = {k: torch.from_numpy(a).to(dev) for k, a in token_batch(b, s, cfg.vocab, seed=0).items()}
    return cfg, batch


def _one_card_steps(cfg, batch, dev) -> tuple:
    """The one-card step's losses and its tree: the parameters after the
    last step and the moments ``SHARDED_MOMENT`` names."""
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train import init_train_state, make_train_step
    oc = OptConfig()
    params, state = init_train_state(0, cfg, oc, device=dev)
    step = make_train_step(cfg, oc)
    losses, ref = [], {}
    for i in range(SHARDED_STEPS):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        ref.update({k: tree_map(torch.clone, state[k[0]]) for k in SHARDED_MOMENT
                    if int(k[1:]) == i + 1})
    ref["params"] = params
    return losses, ref


def _sharded_rank(rank, world, tmp, shape):
    """A rank on card ``rank``: the one-card step on its own card (the same
    seeded weights and batch on every card), then the train state cut into
    its blocks on a ``shape`` ("data", "model") mesh, the sharded steps,
    and each block's and moment's gap to its part of the one-card tree."""
    from repro_torch.sharding import blocks
    from repro_torch.sharding import rules
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves
    dev = LM.start_process_group("nccl", rank, world, f"file://{tmp}/rdv", device=f"cuda:{rank}",
                                 timeout_s=240)
    try:
        mesh = LM.make_mesh_compat(shape, ("data", "model"))
        cfg, batch = _sharded_setup("llama3.2-3b", dict(dtype="float32", n_layers=2), 4, 512, dev)
        want, ref = _one_card_steps(cfg, batch, dev)
        oc = OptConfig()
        params, state = init_train_state(0, cfg, oc, device=dev, mesh=mesh)
        step = make_train_step(cfg, oc, mesh=mesh)
        specs = rules.param_specs(T.param_spec(cfg), mesh)
        out = {"one_card": want, "losses": [], "moments": {}}
        for i in range(SHARDED_STEPS):
            reset_launches()
            params, state, metrics = step(params, state, batch)
            out["losses"].append(float(metrics["loss"]))
            for key in ("m", "v"):
                if f"{key}{i + 1}" in ref:
                    out["moments"][f"{key}{i + 1}"] = max(
                        float((blk - blocks.local_block(full, spec, mesh)).abs().max())
                        / max(float(full.abs().max()), 1e-30)
                        for blk, spec, full in zip(tree_leaves(state[key]), tree_leaves(specs),
                                                   tree_leaves(ref[f"{key}{i + 1}"])))
        out["launches"] = launch_counts()
        size = 2 * oc.lr * SHARDED_STEPS
        out["over_bound"] = 0.0
        for blk, spec, full in zip(tree_leaves(params), tree_leaves(specs),
                                   tree_leaves(ref["params"])):
            want = blocks.local_block(full, spec, mesh)
            ulp = torch.exp2((torch.frexp(want.abs() + size)[1] - 24).float())
            bound = size + SHARDED_STEPS * ulp
            out["over_bound"] = max(out["over_bound"], float(((blk - want).abs() / bound).max()))
    finally:
        torch.distributed.destroy_process_group()
    return out


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_sharded_step_over_nccl_on_two_cards(cuda, tmp_path, shape):
    """Each rank on a card of its own, the collectives card to card: the
    losses, moments and parameters of the one-card step at Z27's f32 bars,
    and each rank's flash launches the code's (2 layers, each forward twice
    under the recompute, one backward)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: nccl puts each rank on a card of its own")
    ranks = LM.spawn_ranks(_sharded_rank, 2, (str(tmp_path), shape), timeout_s=600)
    print(f"sharded step on two cards at {shape}:", ranks)
    for r in ranks:
        want = r["one_card"]
        for got, loss in zip(r["losses"], want):
            assert abs(got - loss) <= SHARDED_LOSS_RTOL * abs(loss), (r["losses"], want)
        assert r["over_bound"] <= 1, r["over_bound"]
        assert set(r["moments"]) == set(SHARDED_MOMENT)
        for k, gap in r["moments"].items():
            assert gap <= SHARDED_MOMENT[k], r["moments"]
        assert r["launches"]["flash_attention"] == {**dict.fromkeys(r["launches"][
            "flash_attention"], 0), "simt_f32": 4, "bwd_f32": 2}


def _jamba_rank(rank, world, tmp):
    """A rank of the whole jamba on card ``rank`` of a (2, 2) mesh: its
    train state's bytes, 2 sharded steps' losses and launches, its peak."""
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves
    dev = LM.start_process_group("nccl", rank, world, f"file://{tmp}/rdv", device=f"cuda:{rank}",
                                 timeout_s=240)
    try:
        mesh = LM.make_mesh_compat((2, 2), ("data", "model"))
        cfg, batch = _sharded_setup("jamba-v0.1-52b", {}, 4, 4096, dev)
        oc = OptConfig()
        params, state = init_train_state(0, cfg, oc, device=dev, mesh=mesh)
        torch.cuda.empty_cache()
        out = {"state_gb": sum(t.numel() * t.element_size()
                               for t in tree_leaves((params, state))) / 1e9, "losses": []}
        step = make_train_step(cfg, oc, mesh=mesh)
        torch.cuda.reset_peak_memory_stats()
        for _ in range(SHARDED_STEPS):
            reset_launches()
            params, state, metrics = step(params, state, batch)
            out["losses"].append(float(metrics["loss"]))
        out["launches"], out["peak_gb"] = launch_counts(), torch.cuda.max_memory_allocated() / 1e9
    finally:
        torch.distributed.destroy_process_group()
    return out


def test_jamba_trains_whole_over_nccl_on_four_cards(cuda, tmp_path):
    """jamba-v0.1-52b with moe=None whole: 9.18 B parameters, about 92 GB of
    train state, a quarter a card.  Step 1's loss is the one-card loss of
    the same weights (bf16 rows split over cards round otherwise), the
    losses fall, and each rank launches the scans and flash as the code
    does: 4 attention and 28 Mamba layers, each forward twice, one
    backward."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: jamba's whole train state does not fit fewer")
    cfg, batch = _sharded_setup("jamba-v0.1-52b", {}, 4, 4096, cuda)
    params = T.init_params(0, cfg, device=cuda)
    with torch.no_grad():
        want = float(T.loss_fn(params, cfg, batch)[0])
    del params, batch
    torch.cuda.empty_cache()
    ranks = LM.spawn_ranks(_jamba_rank, 4, (str(tmp_path),), timeout_s=900)
    print(f"jamba on four cards: one-card loss {want}", ranks)
    for r in ranks:
        losses = r["losses"]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
        assert abs(losses[0] - want) <= JAMBA_LOSS_RTOL * abs(want), (losses, want)
        assert 21 <= r["state_gb"] <= 25, r["state_gb"]
        assert r["launches"]["flash_attention"] == {**dict.fromkeys(r["launches"][
            "flash_attention"], 0), "wgmma_bf16": 2 * 4, "bwd_bf16": 4}
        assert r["launches"]["mamba_scan"] == {**dict.fromkeys(r["launches"]["mamba_scan"], 0),
                                              "chain": 56, "bwd": 28}


# sharded serving over nccl (ROADMAP A14d, A14d2): llama3-8b, rwkv6-1.6b,
# jamba-v0.1-52b as served (moe=None) and whisper-tiny whole in bf16 on two
# cards at ("data", "model") = (1, 2) and (2, 1), against one card; then on
# four cards at (1, 4) internvl2-76b, first cut to 24 layers (Z20a's size)
# against one card, then whole, and jamba-v0.1-52b (moe=None) whole against
# one card.  Each rank serves on its own card
# (nccl, one rank a card), its weights drawn block by block
# (init_params(..., mesh=, profile="inference")).  Bars: each teacher-forced
# step's logits within SERVE_RTOL of its max |logit|, or within twice the
# one-card steps' response to every embedding entry moved by one rounding
# where that is larger (PERF.md's rule for bf16 served logits): bf16
# products over a rank's heads and hidden units, the row-parallel sums
# added in f32 and rounded once where one card's product rounds once in
# another order, so some bf16 roundings differ and the random-weight model
# carries each through its layers (internvl2-76b at 24 layers on four H100s
# parted by 2.29e-2 against a one-ulp response of 3.77e-2; llama3-8b at (2,
# 1), which sums nothing, by 0); and the greedy tokens equal where the
# one-card run's top two stand more than twice the step's logit error apart
SERVE_RTOL = 2e-2
SERVE_PROMPT, SERVE_NEW = 512, 8
INTERNVL_PROMPT, INTERNVL_NEW, INTERNVL_SLOTS = 1024, 16, 4096


def _serve_batch(cfg, b, s, dev, seed=4):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))
             .to(dev)}
    front = {"vlm": ("patch_embeds", cfg.n_patches), "encdec": ("frames", cfg.n_frames)}
    if cfg.family in front:
        key, n = front[cfg.family]
        pe = rng.standard_normal((b, n, cfg.d_frontend)).astype(np.float32)
        batch[key] = torch.from_numpy(pe).to(dev, cfg.tdtype)
    return batch


def _serve_launches(cfg, n_new) -> tuple:
    """``{kernel: n}`` of a prefill and of ``n_new`` decode steps of
    ``cfg``: flash once an attention layer, cross-attention and encoder
    layer at the prefill and never at decode; each scan once a layer of its
    mixer at the prefill and in every step."""
    descs, n_groups = T.block_structure(cfg)
    flash = n_groups * sum((d.mixer == "attn") + d.cross for d in descs)
    flash += cfg.n_enc_layers if cfg.family == "encdec" else 0
    scans = {k: n_groups * sum(d.mixer == mixer for d in descs)
             for k, mixer in (("rwkv6_scan", "rwkv"), ("mamba_scan", "mamba"))}
    return ({"flash_attention": flash, **scans},
            {"flash_attention": 0, **{k: n * n_new for k, n in scans.items()}})


def _serve_steps(params, cfg, batch, slots, n_new, tokens=None, mesh=None):
    """Prefill and ``n_new`` decode steps, greedy or fed ``tokens`` (B,
    n_new): each step's logits (n_new + 1, B, V) f32, the tokens fed, and
    the prefill's and the decode steps' launches."""
    with torch.inference_mode():
        reset_launches()
        logits, cache, pos = T.prefill(params, cfg, batch, slots, mesh=mesh)
        counts = {"prefill": launch_counts()}
        reset_launches()
        steps, fed = [logits.float()], []
        for i in range(n_new):
            tok = (torch.argmax(steps[-1], -1).to(torch.int32)[:, None] if tokens is None
                   else tokens[:, i:i + 1])
            fed.append(tok)
            logits, cache = T.serve_step(params, cfg, cache, tok, pos + i, mesh=mesh)
            steps.append(logits)
        counts["decode"] = launch_counts()
    return torch.stack(steps), torch.cat(fed, 1), counts


def _ulp_response(params, cfg, batch, slots, tokens, want) -> float:
    """How far the one-card steps ``want`` move with every embedding entry
    moved by one rounding (printed beside the bar, not a bar)."""
    embed = params["embed"].clone()
    embed.view(torch.int16).bitwise_xor_(1)
    moved, _, _ = _serve_steps({**params, "embed": embed}, cfg, batch, slots,
                               tokens.shape[1], tokens)
    return float(((moved - want).abs().amax(-1).amax(-1) / want.abs().amax(-1).amax(-1)).max())


def _hold_steps(got, want, want_tokens) -> dict:
    """The teacher-forced steps ``got`` against the one-card ``want``: the
    worst gap relative to each step's max, and the greedy picks that differ
    where the one-card margin exceeds twice the step's error."""
    err = (got - want).abs().amax(-1)                          # (steps, B)
    top = want.abs().amax(-1).amax(-1)                         # (steps,)
    vals = want.topk(2, dim=-1).values
    margin = vals[..., 0] - vals[..., 1]
    differ = got.argmax(-1) != want.argmax(-1)
    return {"rel_err": float((err.amax(-1) / top).max()),
            "clear_flips": int((differ & (margin > 2 * err)).sum()),
            "flips": int(differ.sum()), "picks": int(differ.numel()),
            "fed_greedy": bool(torch.equal(want.argmax(-1)[:-1].T.int(), want_tokens))}


def _serve_rank(rank, world, tmp, arch, shape, b, prompt, n_new):
    """A rank on card ``rank``: the one-card run on its own card (the same
    seeded weights and batch on every card, greedy), then its blocks on a
    ``shape`` ("data", "model") mesh and the same steps fed the one-card
    tokens, held to the one-card logits."""
    from repro_torch.tree import tree_leaves
    dev = LM.start_process_group("nccl", rank, world, f"file://{tmp}/rdv", device=f"cuda:{rank}",
                                 timeout_s=600)
    try:
        mesh = LM.make_mesh_compat(shape, ("data", "model"))
        cfg = dataclasses.replace(get_config(arch), **SERVED.get(arch, {}))
        batch = _serve_batch(cfg, b, prompt, dev)
        slots = prompt + (cfg.n_patches if cfg.family == "vlm" else 0) + n_new
        params = T.init_params(0, cfg, device=dev)
        want, tokens, _ = _serve_steps(params, cfg, batch, slots, n_new)
        ulp = _ulp_response(params, cfg, batch, slots, tokens, want)
        del params
        torch.cuda.empty_cache()
        params = T.init_params(0, cfg, device=dev, mesh=mesh, profile="inference")
        got, _, counts = _serve_steps(params, cfg, batch, slots, n_new, tokens, mesh)
        out = dict(_hold_steps(got, want, tokens), launches=counts, one_ulp_response=ulp,
                   block_gb=sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9)
    finally:
        torch.distributed.destroy_process_group()
    return out


def _check_serve_rank(r, cfg, n_new=SERVE_NEW):
    """A rank's hold (:func:`_hold_steps`) within its bar, and its
    launches equal to the code's (:func:`_serve_launches`), flash on
    ``wgmma_bf16``."""
    assert r["fed_greedy"]
    assert r["rel_err"] <= max(SERVE_RTOL, 2 * r["one_ulp_response"]), r
    assert r["clear_flips"] == 0, r
    for when, want in zip(("prefill", "decode"), _serve_launches(cfg, n_new)):
        got = r["launches"][when]
        assert got["flash_attention"] == {**dict.fromkeys(got["flash_attention"], 0),
                                          "wgmma_bf16": want["flash_attention"]}, when
        assert {k: sum(c.values()) for k, c in got.items()} == {
            k: want.get(k, 0) for k in got}, (when, got)


@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-1.6b", "jamba-v0.1-52b", "whisper-tiny"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_sharded_serving_over_nccl_on_two_cards(cuda, tmp_path, shape, arch):
    """Each arch whole in bf16 (jamba as served, ``moe=None``), B 4 x 512
    tokens (whisper over N(0, 1) frames), 8 steps: each card's
    teacher-forced logits within SERVE_RTOL of one card's, the greedy picks
    equal where the margin allows, the kernels launched as the code says
    (flash on ``wgmma_bf16`` at the prefill only; llama3-8b's 32 over a
    rank's heads at (1, 2), its two rows at (2, 1); rwkv6_scan over a
    rank's 16 heads, mamba_scan over its 4096 channels, whisper's 6 heads
    over 3 a rank)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: nccl puts each rank on a card of its own")
    ranks = LM.spawn_ranks(_serve_rank, 2, (str(tmp_path), arch, shape, 4, SERVE_PROMPT,
                                            SERVE_NEW), timeout_s=900)
    print(f"sharded serving of {arch} on two cards at {shape}:", ranks)
    cfg = dataclasses.replace(get_config(arch), **SERVED.get(arch, {}))
    for r in ranks:
        _check_serve_rank(r, cfg)


def _profiled(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall time, the
    device's busy time (the union of its kernel and copy intervals), the
    time in NCCL kernels (which include waiting for the other ranks), and
    the host operators and device kernels with the most self time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(a):
        return getattr(a, "self_device_time_total", None) or getattr(a, "self_cuda_time_total", 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.name != "Command Buffer Full")
    busy, end = 0.0, float("-inf")
    for lo, hi, _ in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    avg = prof.key_averages()
    return {"wall_ms": 1e3 * wall, "busy_ms": busy / 1e3,
            "nccl_ms": sum(hi - lo for lo, hi, name in spans if "nccl" in name.lower()) / 1e3,
            "host_top": [(a.key[:60], a.count, a.self_cpu_time_total / 1e3)
                         for a in sorted(avg, key=lambda a: -a.self_cpu_time_total)[:10]],
            "device_top": [(a.key[:60], a.count, dev_us(a) / 1e3)
                           for a in sorted(avg, key=lambda a: -dev_us(a))[:10]]}


def _internvl_rank(rank, world, tmp):
    """A rank of internvl2-76b on card ``rank`` of a (1, 4) mesh: first at
    24 layers against the one-card run on its own card; then whole, its
    blocks' bytes, a ServingEngine run (B 4 x 1024 tokens after 256 zero
    patches, 16 new tokens, a 4096-slot cache) counted, and a replay,
    prefill and decode timed apart between barriers, fed the served tokens,
    and one more decode step under the profiler; its peak."""
    from repro_torch.tree import tree_leaves
    dev = LM.start_process_group("nccl", rank, world, f"file://{tmp}/rdv", device=f"cuda:{rank}",
                                 timeout_s=900)
    out = {}
    try:
        mesh = LM.make_mesh_compat((1, 4), ("data", "model"))
        cfg = dataclasses.replace(get_config("internvl2-76b"), n_layers=24)
        batch = _serve_batch(cfg, 4, SERVE_PROMPT, dev)
        slots = cfg.n_patches + SERVE_PROMPT + SERVE_NEW
        params = T.init_params(0, cfg, device=dev)
        want, tokens, _ = _serve_steps(params, cfg, batch, slots, SERVE_NEW)
        ulp = _ulp_response(params, cfg, batch, slots, tokens, want)
        del params
        torch.cuda.empty_cache()
        params = T.init_params(0, cfg, device=dev, mesh=mesh, profile="inference")
        got, _, counts = _serve_steps(params, cfg, batch, slots, SERVE_NEW, tokens, mesh)
        out["layers24"] = dict(_hold_steps(got, want, tokens), launches=counts,
                               one_ulp_response=ulp)
        del params, got, want
        torch.cuda.empty_cache()

        cfg = get_config("internvl2-76b")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = T.init_params(0, cfg, device=dev, mesh=mesh, profile="inference")
        torch.cuda.synchronize()
        whole = {"init_s": time.perf_counter() - t0,
                 "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                 "block_gb": sum(t.numel() * t.element_size()
                                 for t in tree_leaves(params)) / 1e9}
        torch.cuda.reset_peak_memory_stats()
        rng = np.random.default_rng(5)
        reqs = [Request(i, rng.integers(0, cfg.vocab, INTERNVL_PROMPT).astype(np.int32),
                        max_new=INTERNVL_NEW) for i in range(4)]
        reset_launches()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        ServingEngine(cfg, params, cache_slots=INTERNVL_SLOTS, device=dev, mesh=mesh).run(reqs)
        torch.cuda.synchronize()
        whole["run_ms"] = 1e3 * (time.perf_counter() - t0)
        whole["launches"] = launch_counts()
        whole["tokens"] = [r.out for r in reqs]
        served = torch.tensor(whole["tokens"], dtype=torch.int32, device=dev)
        batch = {"tokens": torch.from_numpy(np.stack([r.prompt for r in reqs])).to(dev),
                 "patch_embeds": torch.zeros((4, cfg.n_patches, cfg.d_frontend),
                                             dtype=cfg.tdtype, device=dev)}
        with torch.inference_mode():
            torch.distributed.barrier()
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            logits, cache, pos = T.prefill(params, cfg, batch, INTERNVL_SLOTS, mesh=mesh)
            torch.cuda.synchronize()
            whole["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
            whole["prefill_launches"] = launch_counts()
            whole["cache_gb"] = sum(t.numel() * t.element_size() for t in tree_leaves(cache)) / 1e9
            torch.distributed.barrier()
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            picks = [torch.argmax(logits.float(), -1)]
            for i in range(INTERNVL_NEW - 1):
                logits, cache = T.serve_step(params, cfg, cache, served[:, i:i + 1], pos + i,
                                             mesh=mesh)
                picks.append(torch.argmax(logits, -1))
            torch.cuda.synchronize()
            whole["decode_ms_per_token"] = 1e3 * (time.perf_counter() - t0) / (INTERNVL_NEW - 1)
            whole["decode_launches"] = launch_counts()
            whole["replay_greedy"] = torch.stack(picks, 1).int().tolist() == whole["tokens"]
            whole["finite"] = bool(torch.isfinite(logits).all())
            # one more step under the profiler: where a token's time goes
            last = INTERNVL_NEW - 1
            torch.distributed.barrier()
            whole["decode_step_profile"] = _profiled(lambda: T.serve_step(
                params, cfg, cache, served[:, last:last + 1], pos + last, mesh=mesh))
        whole["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["whole"] = whole
    finally:
        torch.distributed.destroy_process_group()
    return out


def test_internvl_serves_whole_over_nccl_on_four_cards(cuda, tmp_path):
    """internvl2-76b: at 24 layers (Z20a's size) each card's teacher-forced
    logits within SERVE_RTOL of one card's; whole (80 layers, 70.6 B
    parameters, 141 GB in bf16: a quarter a card), the four ranks' tokens
    identical, 80 ``wgmma_bf16`` flash forwards a rank at the prefill (its
    16 query heads over 2 kv heads) and none at decode."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: internvl2-76b whole does not fit fewer")
    ranks = LM.spawn_ranks(_internvl_rank, 4, (str(tmp_path),), timeout_s=1500)
    print("internvl2-76b on four cards:", ranks)
    for r in ranks:
        _check_serve_rank(r["layers24"], dataclasses.replace(get_config("internvl2-76b"),
                                                             n_layers=24))
        whole = r["whole"]
        assert whole["tokens"] == ranks[0]["whole"]["tokens"]
        assert all(len(t) == INTERNVL_NEW for t in whole["tokens"])
        assert whole["finite"]
        for key in ("launches", "prefill_launches"):
            assert whole[key]["flash_attention"] == {
                **dict.fromkeys(whole[key]["flash_attention"], 0), "wgmma_bf16": 80}, key
        assert not any(sum(c.values()) for c in whole["decode_launches"].values())
        assert 33 <= whole["block_gb"] <= 38, whole["block_gb"]


def _jamba_serve_rank(rank, world, tmp):
    """jamba-v0.1-52b as served (``moe=None``) whole on card ``rank`` of a
    (1, 4) mesh: the one-card run on its own card, then its blocks drawn
    block by block (their bytes, the init peak), the steps fed the one-card
    tokens and held; then the prefill and the decode steps timed apart
    between barriers, and the serving peak."""
    from repro_torch.tree import tree_leaves
    dev = LM.start_process_group("nccl", rank, world, f"file://{tmp}/rdv", device=f"cuda:{rank}",
                                 timeout_s=900)
    try:
        mesh = LM.make_mesh_compat((1, 4), ("data", "model"))
        cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), **SERVED["jamba-v0.1-52b"])
        batch = _serve_batch(cfg, 4, SERVE_PROMPT, dev)
        slots = SERVE_PROMPT + SERVE_NEW
        params = T.init_params(0, cfg, device=dev)
        want, tokens, _ = _serve_steps(params, cfg, batch, slots, SERVE_NEW)
        ulp = _ulp_response(params, cfg, batch, slots, tokens, want)
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = T.init_params(0, cfg, device=dev, mesh=mesh, profile="inference")
        torch.cuda.synchronize()
        out = {"init_s": time.perf_counter() - t0,
               "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "block_gb": sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9}
        torch.cuda.reset_peak_memory_stats()
        got, _, counts = _serve_steps(params, cfg, batch, slots, SERVE_NEW, tokens, mesh)
        out.update(_hold_steps(got, want, tokens), launches=counts, one_ulp_response=ulp)
        with torch.inference_mode():
            torch.distributed.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache, pos = T.prefill(params, cfg, batch, slots, mesh=mesh)
            torch.cuda.synchronize()
            out["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
            torch.distributed.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(SERVE_NEW):
                logits, cache = T.serve_step(params, cfg, cache, tokens[:, i:i + 1], pos + i,
                                             mesh=mesh)
            torch.cuda.synchronize()
            out["decode_ms_per_token"] = 1e3 * (time.perf_counter() - t0) / SERVE_NEW
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        torch.distributed.destroy_process_group()
    return out


def test_jamba_serves_whole_over_nccl_on_four_cards(cuda, tmp_path):
    """jamba-v0.1-52b as served (``moe=None``: 32 layers, 9.18 B parameters,
    18.4 GB in bf16) on four cards at (1, 4), B 4 x 512 tokens, 8 steps: each
    card's teacher-forced logits within SERVE_RTOL of one card's (or twice
    its one-ulp response), the greedy picks equal where the margin allows,
    4 flash forwards on ``wgmma_bf16`` at the prefill, ``mamba_scan`` 28 at
    the prefill and 28 a step on the rank's 2048 channels; a quarter of the
    weights a card (4.595 GB: every cut leaf a quarter, the norms whole)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: nccl puts each rank on a card of its own")
    ranks = LM.spawn_ranks(_jamba_serve_rank, 4, (str(tmp_path),), timeout_s=900)
    print("jamba-v0.1-52b (moe=None) on four cards:", ranks)
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), **SERVED["jamba-v0.1-52b"])
    for r in ranks:
        _check_serve_rank(r, cfg)
        assert 4.5 <= r["block_gb"] <= 4.7, r["block_gb"]
