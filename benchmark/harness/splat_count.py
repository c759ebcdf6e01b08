"""The yardstick of the splatfacto cell: the operations and bytes of K5's forward and backward, and
the model FLOPs of a splatfacto train step, counted by hand from the shapes and the listed pairs.

K5 (the port's tile rasterizer) is counted from the (tile, gaussian) pairs its lists hold after
truncation, times the 256 pixels of a tile, so that any implementation of the same lists reads the
same work. Arithmetic is counted as the JAX package's formula writes it, a multiply-add as two
operations; exp, min, max and clip are not counted (so the count cannot pass what the card must
issue). Per pixel and listed pair:

* forward, ``RASTER_FWD_OPS`` = 26: the offset to the mean 2, the quadratic form of the conic and
  its -0.5 10, opacity times exp 1, the weight alpha T 1, the colour, alpha and depth sums 9, the
  transmittance's (1 - alpha + 1e-10) and its product 3;
* backward, ``RASTER_BWD_OPS`` = 64: the forward's terms again 17, the upstream weight g (dC . c +
  dA + dD d) 8, its running sum 2, dalpha (g T less the later part over 1 - alpha + 1e-10) 4, the
  power's and the opacity's gradients 3, the mean's 8, the conic's 8, the colour's and depth's 4,
  and the sums of the ten gradients over the pixels 10.

Bytes, each read or written once: a listed pair reads its gaussian's id (4) and ten float32
features (40); a launch reads each tile's first entry and count (12) and writes five floats a pixel
(colour, alpha, depth); the backward reads those five and their five gradients a pixel and adds ten
gradients a listed pair (40).

A step's model FLOPs: the projection and the SH colours of every gaussian (``PROJECT_OPS`` and
``SH_OPS``, a backward twice its forward), K5 both ways, the SSIM's five 7 x 7 window sums of three
channels at every pixel (a backward twice its forward) and Adam's 12 operations a parameter.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

TILE_PIXELS = 256
RASTER_FWD_OPS = 26
RASTER_BWD_OPS = 64
PAIR_BYTES = 4 + 4 * 10
# a gaussian's EWA projection: the quaternion's rotation 40, R S 9, its covariance 45, the camera
# frame 18, the 2D mean 8, the Jacobian 10, W cov W^T 90, J cov J^T 50, blur, eigenvalue and radius
# 14, conic 6, opacity 4, the features' depth and in-view test 6
PROJECT_OPS = 300
ADAM_OPS = 12


def sh_ops(degree: int) -> int:
    """A gaussian's colour: the direction's normalization 10, the basis (about 3 a function), the
    bands' sum (2 a function and channel) and the sigmoid DC colour and clamp 9."""
    bands = (degree + 1) ** 2 - 1
    return 10 + 3 * bands + 2 * 3 * bands + 9


@dataclass
class SplatLayout:
    """What one step of the cell computes: the gaussians' capacity, the image, the tiles' list
    length and the SH degree."""

    gaussians: int
    height: int
    width: int
    top_k: int
    sh_degree: int

    @property
    def pixels(self) -> int:
        return self.height * self.width

    @property
    def tiles(self) -> int:
        return -(-self.height // 16) * -(-self.width // 16)

    @property
    def params_per_gaussian(self) -> int:
        return 3 + 3 + 4 + 1 + 3 + 3 * ((self.sh_degree + 1) ** 2 - 1)


def raster_fwd(pairs: float, layout: SplatLayout, launches: int = 1) -> Tuple[float, float]:
    """(bytes, ops) of ``launches`` K5 forward launches that list ``pairs`` pairs in all."""
    nbytes = pairs * PAIR_BYTES + launches * (layout.tiles * 12 + layout.pixels * 5 * 4)
    return float(nbytes), float(pairs) * TILE_PIXELS * RASTER_FWD_OPS


def raster_bwd(pairs: float, layout: SplatLayout, launches: int = 1) -> Tuple[float, float]:
    """(bytes, ops) of ``launches`` K5 backward launches over ``pairs`` listed pairs in all."""
    nbytes = pairs * (PAIR_BYTES + 4 * 10) + launches * (layout.tiles * 12 + layout.pixels * 10 * 4)
    return float(nbytes), float(pairs) * TILE_PIXELS * RASTER_BWD_OPS


def step_flops(layout: SplatLayout, pairs: float) -> float:
    """Model FLOPs of one train step whose tiles list ``pairs`` pairs."""
    per_gaussian = 3.0 * (PROJECT_OPS + sh_ops(layout.sh_degree))
    raster = float(pairs) * TILE_PIXELS * (RASTER_FWD_OPS + RASTER_BWD_OPS)
    ssim = 3.0 * 5 * 49 * 3 * layout.pixels
    adam = ADAM_OPS * layout.gaussians * layout.params_per_gaussian
    return layout.gaussians * per_gaussian + raster + ssim + adam
