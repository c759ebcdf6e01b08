"""K5, the tile rasterizer (``ops/splat.py``, ``csrc/splat_raster.cu``), against its plain version.

On the CPU: ``render`` refuses inputs the kernel does not take, and the plain version composited in
blocks of tiles under ``torch.utils.checkpoint`` (as it runs at the cell's size on the card) gives the
one-block image, stats and gradient. The tests marked ``cuda`` hold the kernels to the plain version on
the card: tiles with fewer gaussians than K, tiles that overflow K, depth ties at the cut and an image
that is not a whole number of tiles. They skip without a card; this file imports no JAX:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_splat_kernel.py
"""

import pytest
import torch

from neuradar_tpu_torch.ops import splat


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(G=400, H=40, W=56, seed=0, ties=False, device="cpu"):
    """Random projected gaussians: features [G, 10] (means over the image, a positive-definite conic,
    opacity, colour, depth), radii and the in-view mask."""
    gen = torch.Generator().manual_seed(seed)
    xy = torch.rand(G, 2, generator=gen) * torch.tensor([W + 20.0, H + 20.0]) - 10.0
    sx, sy = torch.rand(G, generator=gen) * 6 + 1, torch.rand(G, generator=gen) * 6 + 1
    rho = torch.rand(G, generator=gen) * 1.2 - 0.6
    a, c, b = sx * sx, sy * sy, rho * sx * sy
    det = a * c - b * b
    depth = torch.rand(G, generator=gen) * 20 + 1
    if ties:
        depth[G // 2:] = depth[:G - G // 2]
    feats = torch.cat([xy, torch.stack([c / det, -b / det, a / det], 1), torch.rand(G, 1, generator=gen) * 0.9,
                       torch.rand(G, 3, generator=gen), depth[:, None]], 1)
    radius = 3 * torch.sqrt(0.5 * (a + c) + torch.sqrt(0.25 * (a - c) ** 2 + b * b))
    in_view = torch.rand(G, generator=gen) > 0.1
    return feats.to(device).contiguous(), radius.to(device), in_view.to(device)


@pytest.mark.parametrize("bad", ["dtype", "width", "radius", "mask"])
def test_render_refuses_what_the_kernel_does_not_take(bad):
    feats, radius, in_view = _inputs()
    if bad == "dtype":
        feats = feats.double()
    elif bad == "width":
        feats = feats[:, :9].contiguous()
    elif bad == "radius":
        radius = radius[:-1]
    else:
        in_view = in_view.float()
    with pytest.raises(ValueError):
        splat.render(feats, radius, in_view, 40, 56, 32)


def test_plain_blocks_match_one_block():
    """Blocks of 2 tiles under checkpointing: the image, the stats and the gradient of one block, to
    float32 round-off (the blocks recompute the same sums)."""
    feats, radius, in_view = _inputs()
    grads = [torch.randn(40, 56, k, generator=torch.Generator().manual_seed(k)) for k in (3, 1, 1)]
    outs = []
    for block in (2, 1000):
        leaf = feats.clone().requires_grad_(True)
        *images, stats = splat.render_plain(leaf, radius, in_view, 40, 56, 32, tiles_per_block=block)
        torch.autograd.backward(images, grads)
        outs.append((images, stats, leaf.grad))
    (images_b, stats_b, grad_b), (images_1, stats_1, grad_1) = outs
    assert stats_b == stats_1 and stats_1[1] > 0
    for x, y in zip(images_b, images_1):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(grad_b, grad_1, rtol=1e-5, atol=1e-7)


CASES = {"fewer_than_k": dict(top_k=400), "overflow": dict(top_k=16), "depth_ties": dict(top_k=24, ties=True),
         "cropped": dict(top_k=32, H=37, W=50)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda, case):
    """The binning's stats exactly; colour, alpha and depth to 1e-5 (other summation orders, the
    card's expf); the features' gradient to 1e-4 a column by relative L2 (the backward's float32
    atomics add in an order that changes from run to run)."""
    kw = dict(CASES[case])
    top_k, H, W = kw.pop("top_k"), kw.pop("H", 40), kw.pop("W", 56)
    feats, radius, in_view = _inputs(H=H, W=W, device=cuda, **kw)
    grads = [torch.randn(H, W, k, device=cuda) for k in (3, 1, 1)]
    results = []
    for fn in (splat.render, splat.render_plain):
        leaf = feats.clone().requires_grad_(True)
        before = (splat.raster_fwd.launches, splat.raster_bwd.launches)
        *images, stats = fn(leaf, radius, in_view, H, W, top_k)
        torch.autograd.backward(images, grads)
        torch.cuda.synchronize()
        results.append((images, stats, leaf.grad, (splat.raster_fwd.launches - before[0],
                                                   splat.raster_bwd.launches - before[1])))
    (k_images, k_stats, k_grad, k_launches), (p_images, p_stats, p_grad, p_launches) = results
    assert k_launches == (1, 1) and p_launches == (0, 0)
    assert k_stats == p_stats
    for x, y in zip(k_images, p_images):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
    for col in range(splat.FEATS):
        want = p_grad[:, col].double()
        gap = float((k_grad[:, col].double() - want).norm() / want.norm().clamp(min=1e-30))
        assert gap < 1e-4, (col, gap)
