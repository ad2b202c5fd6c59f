"""The port's bottleneck kernels on the CPU (their plain versions) against
the JAX package's Pallas kernels in interpret mode, and the wrappers'
dispatch and input checks."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.kernels.bottleneck_compress import bottleneck_compress as pallas_compress  # noqa: E402
from repro.kernels.bottleneck_decompress import bottleneck_decompress_any  # noqa: E402
from repro_torch.kernels import launch_counts, ref, tiles  # noqa: E402
from repro_torch.kernels.bottleneck_compress import bottleneck_compress  # noqa: E402
from repro_torch.kernels.bottleneck_decompress import bottleneck_decompress  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan  # noqa: E402

# (N, C, L); the Pallas kernel needs N and C to be whole tiles
SHAPES = [(128, 256, 128), (256, 512, 64), (64, 96, 48)]


def _compress_inputs(n, c, l, *, exact: bool):
    rng = np.random.default_rng(n + c + l)
    if exact:
        # small dyadic values: every product and partial sum is exact in f32,
        # so any summation order gives the same z, and z / s hits ties
        f = rng.integers(-8, 9, (n, c)).astype(np.float32)
        w = rng.integers(-4, 5, (c, l)).astype(np.float32) / 8
        b = rng.integers(-4, 5, (l,)).astype(np.float32) / 4
    else:
        f = rng.standard_normal((n, c)).astype(np.float32)
        w = (rng.standard_normal((c, l)) * 0.05).astype(np.float32)
        b = (rng.standard_normal(l) * 0.1).astype(np.float32)
    return f, w, b


def _ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_compress_exact_sums_match_pallas(shape):
    """With exact sums the quantiser alone decides: scales within 1 ulp, and
    codes equal except by one where z / s sits on a rounding tie (XLA may
    divide by the row scale as a multiply by its reciprocal)."""
    f, w, b = _compress_inputs(*shape, exact=True)
    qj, sj = (np.asarray(a) for a in pallas_compress(f, w, b, interpret=True))
    qt, st = bottleneck_compress(torch.tensor(f), torch.tensor(w), torch.tensor(b))
    assert qt.dtype == torch.int8 and st.shape == (shape[0], 1)
    assert _ulps(st.numpy(), sj) <= 1
    diff = qt.numpy().astype(int) - qj
    assert np.abs(diff).max() <= 1
    ratio = np.maximum(f.astype(np.float64) @ w + b, 0) / sj
    frac = np.abs(ratio - np.floor(ratio) - 0.5)
    assert (frac[diff != 0] < 1e-5).all(), "a code moved away from a rounding tie"


@pytest.mark.parametrize("shape", SHAPES)
def test_compress_gaussian_matches_pallas(shape):
    """Gaussian inputs: the f32 products sum in another order, so a code may
    move by one at a rounding tie, and a scale by the sum-order error of a
    dot over C <= 512 terms (measured at most 16 ulp, bar 2e-6 relative)."""
    f, w, b = _compress_inputs(*shape, exact=False)
    qj, sj = (np.asarray(a) for a in pallas_compress(f, w, b, interpret=True))
    qt, st = bottleneck_compress(torch.tensor(f), torch.tensor(w), torch.tensor(b))
    assert np.abs(qt.numpy().astype(int) - qj).max() <= 1
    np.testing.assert_allclose(st.numpy(), sj, rtol=2e-6, atol=0)


def test_compress_zero_rows_take_unit_scale():
    f = np.zeros((4, 8), np.float32)
    w = np.ones((8, 3), np.float32)
    q, s = bottleneck_compress(torch.tensor(f), torch.tensor(w), torch.zeros(3))
    assert not q.any() and torch.equal(s, torch.ones(4, 1))


@pytest.mark.parametrize("shape", SHAPES)
def test_decompress_matches_pallas(shape):
    n, c, l = shape
    rng = np.random.default_rng(n * c)
    q = rng.integers(-127, 128, (n, l)).astype(np.int8)
    s = (rng.random((n, 1)) * 0.1 + 1e-3).astype(np.float32)
    w = (rng.standard_normal((l, c)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    want = np.asarray(bottleneck_decompress_any(q, s, w, b, backend="interpret"))
    got = bottleneck_decompress(*(torch.tensor(a) for a in (q, s, w, b)))
    assert got.dtype == torch.float32 and got.shape == (n, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    before = launch_counts()
    f, w, b = (torch.tensor(a) for a in _compress_inputs(64, 96, 48, exact=False))
    q, s = bottleneck_compress(f, w, b)
    qr, sr = ref.bottleneck_compress_ref(f, w, b)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    wd = torch.randn(48, 96)
    out = bottleneck_decompress(q, s, wd, torch.zeros(96))
    assert torch.equal(out, ref.bottleneck_decode_ref(q, s, wd, torch.zeros(96)))
    assert launch_counts() == before


def test_ragged_and_empty_rows():
    f, w, b = (torch.tensor(a) for a in _compress_inputs(7, 13, 5, exact=False))
    q, s = bottleneck_compress(f, w, b)
    assert q.shape == (7, 5) and s.shape == (7, 1)
    q0, s0 = bottleneck_compress(f[:0], w, b)
    assert q0.shape == (0, 5) and s0.shape == (0, 1)
    assert bottleneck_decompress(q0, s0, torch.zeros(5, 13), torch.zeros(13)).shape == (0, 13)


def test_wrappers_check_their_inputs():
    f, w, b = torch.zeros(4, 8), torch.zeros(8, 3), torch.zeros(3)
    with pytest.raises(ValueError, match="shape mismatch"):
        bottleneck_compress(f, torch.zeros(7, 3), b)
    with pytest.raises(TypeError, match="float32"):
        bottleneck_compress(f.double(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        bottleneck_compress(torch.zeros(8, 4).t(), w, b)
    q, s = torch.zeros(4, 3, dtype=torch.int8), torch.ones(4, 1)
    with pytest.raises(TypeError, match="int8"):
        bottleneck_decompress(q.float(), s, torch.zeros(3, 8), torch.zeros(8))
    with pytest.raises(ValueError, match="shape mismatch"):
        bottleneck_decompress(q, torch.ones(3, 1), torch.zeros(3, 8), torch.zeros(8))


# (N, K, M) of the codec products on the main path (full-width VGG16 at batch
# 8: relu3, pool16, pool23, flatten, fc0_relu), the extra shapes of
# chip_smoke.py (N = 1, ragged rows and columns, one two-image client at
# pool23, the llama3.2-3b cut), each as compress (N, C, L) and decompress
# (N, L, C) take it, and N 0, 1, 16 and 17 around the streaming tile's edge
_COMPRESS = [(401408, 64, 32), (6272, 256, 128), (1568, 512, 256), (8, 25088, 12544),
             (8, 4096, 2048), (1, 512, 256), (4237, 96, 48), (777, 300, 100),
             (392, 512, 256), (8000, 3072, 1536)]
PICK_SHAPES = (_COMPRESS + [(n, m, k) for n, k, m in _COMPRESS]
               + [(0, 512, 256), (1, 4096, 2048), (16, 4096, 2048), (17, 4096, 2048)])


@pytest.mark.parametrize("shape", PICK_SHAPES)
def test_pick_names_a_tile_at_every_path_shape(shape):
    n, k, m = shape
    tile = tiles.pick_tile(n, k, m, 132)
    assert tile in tiles.TILES
    if n <= tiles.STREAM_ROWS:
        assert tile == "stream"
    # no tile is picked whose grid leaves more than half the card idle,
    # unless the 8-row tile's grid does as well
    if tiles.blocks(tile, n, m) < 66:
        assert tiles.blocks("stream", n, m) < 66


@pytest.mark.parametrize("shape, tile", [
    ((8000, 3072, 1536), "wide"), ((8000, 1536, 3072), "wide"),      # the llama cut
    ((401408, 32, 64), "wide"),                                       # relu3 decompress
    ((401408, 64, 32), "narrow"), ((6272, 256, 128), "mid"),          # relu3, pool16
    ((6272, 128, 256), "mid"), ((1568, 512, 256), "mid"), ((1568, 256, 512), "mid"),
    ((4237, 48, 96), "narrow"), ((777, 100, 300), "narrow"),          # ragged widths
    ((777, 300, 100), "stream"),                                      # 52 narrow blocks
    ((392, 512, 256), "stream"), ((392, 256, 512), "mid"),            # a pool23 client
    ((8, 25088, 12544), "stream"), ((8, 4096, 2048), "stream"), ((1, 512, 256), "stream")])
def test_pick_at_the_measured_shapes(shape, tile):
    """The pick at the shapes whose tiles were timed on an H100 (132 SMs)."""
    assert tiles.pick_tile(*shape, 132) == tile
    assert tiles.blocks("wide", 8000, 1536) == 125 * 24


def test_pick_streams_up_to_16_rows_and_fills_the_card_after():
    # at 16 rows the 8-row tile even where a 64-column tile would fill the
    # card; at 17 that tile, and the 8-row tile again where it would not
    assert tiles.pick_tile(16, 4096, 16384, 132) == "stream"
    assert tiles.pick_tile(17, 4096, 16384, 132) == "mid"
    assert tiles.blocks("mid", 17, 2048) == 32
    assert tiles.pick_tile(17, 4096, 2048, 132) == "stream"


def test_tile_table_matches_the_cuda_header():
    """``kernels/tiles.py`` and ``csrc/sgemm_tile.cuh`` list the same tiles
    in the same order (the launchers take the index), with the same block
    rows and columns (the pick's grid counts)."""
    from pathlib import Path
    import re
    src = (Path(tiles.__file__).resolve().parents[1] / "csrc" / "sgemm_tile.cuh").read_text()
    header = dict(re.findall(r"using (\w+) = Tile<([\d, ]+)>;", src))
    order = re.findall(r"case \d+: return f\((\w+)\{\}\);", src)
    assert [n.lower() for n in order] == list(tiles.TILES)
    for name, (bm, bn) in tiles.TILES.items():
        assert tuple(int(x) for x in header[name.capitalize()].split(","))[:2] == (bm, bn)


@pytest.mark.parametrize("tile", ["rows", "cols", "tiled", "Wide"])
def test_unknown_tile_raises_on_cpu_tensors(tile):
    f, w, b = torch.zeros(4, 8), torch.zeros(8, 3), torch.zeros(3)
    with pytest.raises(ValueError, match="unknown tile"):
        bottleneck_compress(f, w, b, tile=tile)
    q, s = torch.zeros(4, 3, dtype=torch.int8), torch.ones(4, 1)
    with pytest.raises(ValueError, match="unknown tile"):
        bottleneck_decompress(q, s, torch.zeros(3, 8), torch.zeros(8), tile=tile)


@pytest.mark.parametrize("tile", list(tiles.TILES))
def test_a_forced_tile_on_cpu_tensors_takes_the_plain_version(tile):
    before = launch_counts()
    f, w, b = (torch.tensor(a) for a in _compress_inputs(64, 96, 48, exact=False))
    q, s = bottleneck_compress(f, w, b, tile=tile)
    qr, sr = ref.bottleneck_compress_ref(f, w, b)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    wd = torch.randn(48, 96)
    out = bottleneck_decompress(q, s, wd, torch.zeros(96), tile=tile)
    assert torch.equal(out, ref.bottleneck_decode_ref(q, s, wd, torch.zeros(96)))
    assert launch_counts() == before


def _grad_cases():
    """Each wrapper on small CPU inputs: (call, inputs, which require grad)."""
    g = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g)
    f = randn(6, 10).abs()
    return {
        "bottleneck_compress": (bottleneck_compress, [f, randn(10, 4) / 3, 0.1 * randn(4)],
                                [True, True, True]),
        "bottleneck_decompress": (
            bottleneck_decompress,
            [torch.randint(-127, 128, (6, 4), generator=g).to(torch.int8),
             0.01 + torch.rand((6, 1), generator=g), randn(4, 10) / 2, randn(10)],
            [False, True, True, True]),
        "flash_attention": (flash_attention, [randn(1, 5, 2, 8), randn(1, 7, 1, 8),
                                              randn(1, 7, 1, 8)], [True, True, True]),
        "rwkv6_scan": (rwkv6_scan, [0.5 * randn(1, 4, 2, 3), 0.5 * randn(1, 4, 2, 3),
                                    0.5 * randn(1, 4, 2, 3),
                                    torch.exp(-torch.exp(randn(1, 4, 2, 3) - 1.0)),
                                    0.3 * randn(2, 3), 0.2 * randn(1, 2, 3, 3)], [True] * 6),
        "mamba_scan": (mamba_scan, [0.1 * torch.nn.functional.softplus(randn(1, 4, 3)),
                                    0.5 * randn(1, 4, 2), 0.5 * randn(1, 4, 2), randn(1, 4, 3),
                                    -torch.exp(0.3 * randn(3, 2)), 0.3 * randn(1, 3, 2)],
                       [True] * 6),
    }


@pytest.mark.parametrize("name", ["bottleneck_compress", "bottleneck_decompress",
                                  "flash_attention", "rwkv6_scan", "mamba_scan"])
def test_plain_dispatch_still_differentiates(name):
    """On CPU tensors a wrapper returns its plain version's differentiable
    result, where a CUDA tensor that requires grad makes it raise
    (tests/test_torch_cuda.py).  Its gradient, projected on a random
    direction, is held to a central difference of the wrapper itself in f32
    (step 1e-3, bar 1e-2 relative: f32 rounding over the step is some 1e-4
    of it; the int8 codes carry no gradient).  The two scans' plain versions
    also take float64, so ``gradcheck`` holds them there too."""
    call, inputs, needs = _grad_cases()[name]
    inputs = [t.clone().requires_grad_(n) for t, n in zip(inputs, needs)]
    gen = torch.Generator().manual_seed(1)

    def loss(args):
        out = call(*args)
        outs = [o for o in (out if isinstance(out, tuple) else (out,)) if o.is_floating_point()]
        return sum((o.double() * torch.randn(o.shape, generator=torch.Generator().manual_seed(i),
                                             dtype=torch.float64)).sum()
                   for i, o in enumerate(outs))
    diff = [t for t in inputs if t.requires_grad]
    grads = torch.autograd.grad(loss(inputs), diff)
    assert all(gr is not None and gr.abs().sum() > 0 for gr in grads)
    dirs = [torch.randn(t.shape, generator=gen) for t in diff]
    analytic = float(sum((gr.double() * d).sum() for gr, d in zip(grads, dirs)))

    def shifted(step):
        moved = iter(dirs)
        return float(loss([(t + step * next(moved)).detach() if t.requires_grad else t
                           for t in inputs]))
    with torch.no_grad():
        numeric = (shifted(1e-3) - shifted(-1e-3)) / 2e-3
    assert abs(analytic - numeric) <= 1e-2 * abs(numeric), (analytic, numeric)
    if name in ("rwkv6_scan", "mamba_scan"):
        plain = ref.rwkv6_scan_ref if name == "rwkv6_scan" else ref.mamba_scan_ref
        assert torch.autograd.gradcheck(
            plain, [t.detach().double().requires_grad_() for t in inputs])
