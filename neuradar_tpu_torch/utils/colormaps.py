"""Colormaps for rendered outputs, in numpy on the host (port of the JAX package's
utils/colormaps.py).

``apply_colormap`` routes by channel count: 3 channels pass through, 1 float channel goes
through a colormap table, booleans become black and white, more than 3 channels are projected
to RGB by PCA. ``apply_depth_colormap`` normalizes to [near, far] and fades to white where the
accumulation is low. The tables of the named colormaps are matplotlib's 256 entries, kept in
``colormap_tables.npz`` beside this file, so that no plotting library is needed.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import Optional

import numpy as np

Colormaps = ("default", "turbo", "viridis", "magma", "inferno", "cividis", "gray", "pca")
_TABLES = Path(__file__).with_name("colormap_tables.npz")


@dataclass
class ColormapOptions:
    colormap: str = "default"
    normalize: bool = False
    colormap_min: float = 0.0
    colormap_max: float = 1.0
    invert: bool = False
    range_min: Optional[float] = None
    range_max: Optional[float] = None


@lru_cache(maxsize=None)
def colormap_table(name: str) -> np.ndarray:
    """The [256, 3] float64 table of a named colormap."""
    with np.load(_TABLES) as z:
        if name not in z.files:
            raise ValueError(f"unknown colormap {name!r}: one of {sorted(z.files)}, 'gray' or 'default'")
        return z[name]


def apply_float_colormap(image: np.ndarray, colormap: str = "viridis") -> np.ndarray:
    """[..., 1] floats in [0, 1] -> [..., 3] colors ("default" and "pca" take turbo for a scalar)."""
    if colormap in ("default", "pca"):
        colormap = "turbo"
    image = np.nan_to_num(np.asarray(image, np.float64), nan=0.0)
    if colormap == "gray":
        return np.repeat(image, 3, axis=-1)
    idx = np.clip((image * 255).astype(np.int64), 0, 255)
    return colormap_table(colormap)[idx[..., 0]]


def apply_boolean_colormap(image: np.ndarray, true_color=(1.0, 1.0, 1.0), false_color=(0.0, 0.0, 0.0)) -> np.ndarray:
    return np.where(np.asarray(image)[..., None], np.asarray(true_color), np.asarray(false_color))


def apply_pca_colormap(image: np.ndarray) -> np.ndarray:
    """[..., D > 3] features -> [..., 3]: the projection on the first three principal axes, each
    scaled to [0, 1] over its samples within 3 median deviations of the median."""
    shape = image.shape
    x = np.asarray(image, np.float64).reshape(-1, shape[-1])
    _, _, vt = np.linalg.svd(x - x.mean(axis=0), full_matrices=False)
    y = x @ vt[:3].T
    d = np.abs(y - np.median(y, axis=0))
    s = d / np.clip(np.median(d, axis=0), 1e-12, None)
    for c in range(3):
        ins = y[s[:, c] < 3.0, c]
        if len(ins) == 0:
            ins = y[:, c]
        y[:, c] = (y[:, c] - ins.min()) / max(ins.max() - ins.min(), 1e-12)
    return np.clip(y, 0, 1).reshape(*shape[:-1], 3)


def apply_colormap(image: np.ndarray, colormap_options: ColormapOptions = ColormapOptions(),
                   eps: float = 1e-9) -> np.ndarray:
    """3 channels pass through; 1 float channel through ``colormap_options``; booleans black and
    white; more than 3 channels by PCA."""
    image = np.asarray(image)
    if image.shape[-1] == 3:
        return image
    o = colormap_options
    lo = o.range_min if o.range_min is not None else image.min()
    hi = o.range_max if o.range_max is not None else image.max()
    image = np.clip(image, lo, hi)
    if image.shape[-1] == 1 and np.issubdtype(image.dtype, np.floating):
        out = image
        if o.normalize:
            out = out - out.min()
            out = out / (out.max() + eps)
        out = np.clip(out * (o.colormap_max - o.colormap_min) + o.colormap_min, 0, 1)
        if o.invert:
            out = 1 - out
        return apply_float_colormap(out, colormap=o.colormap)
    if image.dtype == bool:
        return apply_boolean_colormap(image[..., 0] if image.shape[-1] == 1 else image)
    if image.shape[-1] > 3:
        return apply_pca_colormap(image)
    raise NotImplementedError(f"no colormap route for shape {image.shape} dtype {image.dtype}")


def apply_depth_colormap(depth: np.ndarray, accumulation: Optional[np.ndarray] = None,
                         near_plane: Optional[float] = None, far_plane: Optional[float] = None,
                         colormap_options: ColormapOptions = ColormapOptions()) -> np.ndarray:
    """[..., 1] depth -> [..., 3] colors, faded to white where ``accumulation`` is low."""
    depth = np.asarray(depth, np.float64)
    near = near_plane if near_plane is not None else float(depth.min())
    far = far_plane if far_plane is not None else float(depth.max())
    norm = np.clip((depth - near) / (far - near + 1e-10), 0, 1)
    colored = apply_colormap(norm, colormap_options=colormap_options)
    if accumulation is not None:
        colored = colored * accumulation + (1 - accumulation)
    return colored
