"""The yardstick of the nerfacto cell: the model FLOPs of a nerfacto train step and the bytes bound of
K4's forward on its three grids, counted by hand from the widths and the samples a step evaluates.

Model FLOPs count the matrix products (2 per multiply-add) of the MLPs at every sample: each proposal
round's density MLP (its grid's L x F features, ``hidden_dim`` wide, one output) at that round's
samples; the field's density MLP (L x F features, ``hidden_dim`` wide, 1 + 15 outputs) and colour MLP
(16 SH + 15 + the appearance embedding in, two ``hidden_dim_color``-wide layers, 3 out) at the field's
samples. A backward is twice its forward. The hash-grid gathers, the samplers, the losses and Adam are
no FLOPs here; their time shows in the layers' device ms.

K4's forward (``hash_encode_fwd``) on a grid of L levels of T rows of F float32 features, at N
samples: the positions are read once (12 bytes a sample) and the output written once (L F 4 bytes a
sample); each level reads every row its lookups reach once, counted as the smallest of its table (T F
4 bytes), its lookups' corner rows (8 F 4 bytes a sample) and the corners of its cells inside the unit
cube ((r + 1)^3 rows at resolution r, which caps the coarse levels). Where the samples spread over the
scene, as the cell's rays do, the lookups reach that many distinct rows, and no encode reads fewer
bytes from DRAM than it reaches: the bound is then a lower bound on DRAM traffic, and a share of it
cannot pass 100 %.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

GEO_FEAT = 15
SH_WIDTH = 16
CORNERS = 8


@dataclass
class Grid:
    levels: int
    rows: int  # T, rows a level
    features: int  # F
    base_res: int
    max_res: int

    def resolutions(self) -> List[float]:
        """Each level's resolution, floored in float32 as the grid computes it."""
        L = self.levels
        growth = math.exp((math.log(self.max_res) - math.log(self.base_res)) / (L - 1)) if L > 1 else 1.0
        levels = np.arange(L).astype(np.float32)
        return np.floor(np.float32(self.base_res) * np.power(np.float32(growth), levels)).tolist()


@dataclass
class NerfactoLayout:
    """What one step of the cell computes: its rays, each proposal round's samples a ray and grid and
    MLP width, the field's samples a ray, its grid and its MLP widths."""

    rays: int
    proposal_samples: Sequence[int]
    proposal_grids: Sequence[Grid]
    proposal_hidden: Sequence[int]
    field_samples: int
    field_grid: Grid
    hidden_dim: int
    hidden_dim_color: int
    appearance_dim: int


def layout_of(model: Dict) -> NerfactoLayout:
    """The layout of a configuration file's ``model`` entry."""
    rounds = len(model["num_proposal_samples_per_ray"])
    args = [model["proposal_net_args_list"][min(i, len(model["proposal_net_args_list"]) - 1)] for i in range(rounds)]
    return NerfactoLayout(
        rays=model["num_rgb_patches"] * model["patch_size"] ** 2,
        proposal_samples=list(model["num_proposal_samples_per_ray"]),
        proposal_grids=[Grid(a["num_levels"], 2 ** a["log2_hashmap_size"], 2, 16, a["max_res"]) for a in args],
        proposal_hidden=[a["hidden_dim"] for a in args],
        field_samples=model["num_nerf_samples_per_ray"],
        field_grid=Grid(model["num_levels"], 2 ** model["log2_hashmap_size"], model["features_per_level"],
                        model["base_res"], model["max_res"]),
        hidden_dim=model["hidden_dim"], hidden_dim_color=model["hidden_dim_color"],
        appearance_dim=model["appearance_embedding_dim"])


def mlp_flops(widths: Sequence[int]) -> float:
    return float(sum(2 * a * b for a, b in zip(widths[:-1], widths[1:])))


def split_rounds(layout: NerfactoLayout, proposal_samples: float) -> List[float]:
    """A count of both rounds' samples split by the rounds' samples a ray."""
    total = sum(layout.proposal_samples)
    return [proposal_samples * n / total for n in layout.proposal_samples]


def forward_flops(layout: NerfactoLayout, proposal_samples: float, field_samples: float) -> float:
    """The MLPs' FLOPs of one forward at these sample counts (both rounds' and the field's)."""
    flops = sum(n * mlp_flops([g.levels * g.features, h, 1])
                for n, g, h in zip(split_rounds(layout, proposal_samples), layout.proposal_grids,
                                   layout.proposal_hidden))
    g = layout.field_grid
    per_field = mlp_flops([g.levels * g.features, layout.hidden_dim, 1 + GEO_FEAT])
    per_field += mlp_flops([SH_WIDTH + GEO_FEAT + layout.appearance_dim, layout.hidden_dim_color,
                            layout.hidden_dim_color, 3])
    return flops + field_samples * per_field


def step_flops(layout: NerfactoLayout, proposal_samples: float, field_samples: float) -> float:
    """A train step's model FLOPs: the forward and a backward of twice its FLOPs."""
    return 3.0 * forward_flops(layout, proposal_samples, field_samples)


def encode_fwd_bytes(grid: Grid, samples: float) -> float:
    """K4 forward's bytes bound on ``grid`` at ``samples`` float32 positions."""
    row = grid.features * 4
    reached = sum(min(grid.rows, CORNERS * samples, (r + 1) ** 3) for r in grid.resolutions())
    return samples * (12 + grid.levels * row) + reached * row


def k4_fwd_bytes(layout: NerfactoLayout, proposal_samples: float, field_samples: float) -> Tuple[float, int]:
    """(bytes bound, encodes) of a step's K4 forwards: one an encode, each proposal round's grid at its
    samples and the field's grid at the field's."""
    encodes = [(g, n) for g, n in zip(layout.proposal_grids, split_rounds(layout, proposal_samples))]
    encodes.append((layout.field_grid, field_samples))
    return sum(encode_fwd_bytes(g, n) for g, n in encodes), len(encodes)
