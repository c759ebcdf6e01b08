"""Radar loss: multi-Bernoulli NLL with an on-device auction assignment (port
of the JAX package's model_components/radar_utils.py, the training path).

Ground-truth scans are padded to [num_scans, max_gt, 3] with a validity mask.
Each GT point is assigned a distinct multi-Bernoulli component by a Jacobi
auction run on the device, batched over scans, for a fixed number of rounds:
the JAX package's while_loop stops once every valid row is assigned, and a
round with no unassigned row changes nothing, so the fixed count gives the
same answer without a host sync per round.
"""

from __future__ import annotations

from typing import Tuple

import torch

EPS = 1e-6
MIN_VAR = 1e-3
MAX_COST = 1e9


def mb_split(prediction: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw radar head output [..., n_mb, 7] -> (existence r, Laplace locations, Laplace scales)."""
    r = torch.clamp(prediction[..., 0], EPS, 1 - EPS)
    return r, prediction[..., 1:4], torch.clamp(prediction[..., 4:7], min=MIN_VAR)


def laplace_log_prob(x: torch.Tensor, loc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return -torch.log(2 * scale) - torch.abs(x - loc) / scale


def radar_cost_matrix(gt: torch.Tensor, gt_mask: torch.Tensor, prediction: torch.Tensor,
                      method: str = "euclidean") -> torch.Tensor:
    """Association cost [N, G, n_mb] between GT points (rows) and components (columns),
    batched over scans: gt [N, G, 3], gt_mask [N, G], prediction [N, n_mb, 7]."""
    r, mean, scale = mb_split(prediction)
    if method == "euclidean":
        cost = torch.linalg.vector_norm(gt[:, :, None, :] - mean[:, None, :, :], dim=-1) - torch.log(r)[:, None, :]
    elif method == "nll":
        logp = laplace_log_prob(gt[:, :, None, :], mean[:, None, :, :], scale[:, None, :, :])
        cost = (torch.log1p(-r) - torch.log(r))[:, None, :] - logp.sum(-1)
    else:
        raise ValueError(method)
    cost = torch.where(torch.isfinite(cost), cost, torch.full_like(cost, MAX_COST))
    return torch.where(gt_mask[:, :, None], cost, torch.full_like(cost, MAX_COST))


def auction_assignment(cost: torch.Tensor, row_mask: torch.Tensor, eps: float = 1e-3,
                       max_iters: int = 64) -> torch.Tensor:
    """Jacobi auction over a batch: cost [N, P, O] (P <= O), row_mask [N, P] -> assigned
    [N, P] long, the column of each valid row, -1 for unassigned or masked rows. Each
    round every unassigned row bids for its best column; each column goes to its highest
    bidder, evicting the previous owner."""
    N, P, O = cost.shape
    device = cost.device
    benefit = -cost
    neg_inf = torch.tensor(float("-inf"), dtype=cost.dtype, device=device)
    price = torch.zeros((N, O), dtype=cost.dtype, device=device)
    owner = torch.full((N, O), -1, dtype=torch.long, device=device)
    assigned = torch.full((N, P + 1), -1, dtype=torch.long, device=device)  # column P absorbs dropped writes
    cols = torch.arange(O, device=device)
    scans = torch.arange(N, device=device)[:, None]
    for _ in range(max_iters):
        unassigned = (assigned[:, :P] < 0) & row_mask
        vals = benefit - price[:, None, :]  # [N, P, O]
        v1, o1 = torch.max(vals, dim=2)  # first maximum, as jnp.argmax
        v2 = torch.max(torch.where(cols == o1[..., None], neg_inf, vals), dim=2).values
        bid = torch.gather(price, 1, o1) + (v1 - v2) + eps  # [N, P]
        bids_on = torch.where((o1[..., None] == cols) & unassigned[..., None], bid[..., None], neg_inf)
        best_bid, best_person = torch.max(bids_on, dim=1)  # [N, O]
        won = best_bid > neg_inf
        # evict the previous owners of won columns, then grant them to the winners
        evict = torch.where(won & (owner >= 0), owner, torch.full_like(owner, P))
        assigned[scans.expand(N, O), evict] = -1
        winner = torch.where(won, best_person, torch.full_like(best_person, P))
        assigned[scans.expand(N, O), winner] = cols.expand(N, O)
        owner = torch.where(won, best_person, owner)
        price = torch.where(won, best_bid, price)
    assigned = assigned[:, :P]
    return torch.where(row_mask, assigned, torch.full_like(assigned, -1))


def radar_scan_loss(gt: torch.Tensor, gt_mask: torch.Tensor, prediction: torch.Tensor,
                    assigned: torch.Tensor) -> torch.Tensor:
    """Per-scan multi-Bernoulli loss [N] given the assignment: every component pays -log(1 - r),
    an associated one instead -log(r) plus its Laplace NLL; normalized by n_mb."""
    N, G, _ = gt.shape
    r, mean, scale = mb_split(prediction)
    n_mb = prediction.shape[-2]
    valid = (assigned >= 0) & gt_mask
    mb_idx = torch.where(valid, assigned, torch.full_like(assigned, n_mb))
    assoc_gt = torch.full((N, n_mb + 1), -1, dtype=torch.long, device=gt.device)
    assoc_gt.scatter_(1, mb_idx, torch.arange(G, device=gt.device).expand(N, G))
    assoc_gt = assoc_gt[:, :n_mb]
    is_assoc = assoc_gt >= 0
    gt_for_mb = torch.gather(gt, 1, torch.clamp(assoc_gt, min=0)[..., None].expand(N, n_mb, 3))
    unassoc_loss = -torch.log1p(-r)
    assoc_loss = -laplace_log_prob(gt_for_mb, mean, scale).sum(-1) - torch.log(r)
    return torch.sum(torch.where(is_assoc, assoc_loss, unassoc_loss), dim=-1) / n_mb


def calculate_radar_loss(gt: torch.Tensor, gt_mask: torch.Tensor, radar_output: torch.Tensor,
                         training: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean radar NLL over scans and the auction's assignment [N, G]. The association cost is
    euclidean in training and the NLL in eval, and carries no gradient. (The JAX package's
    euclidean loss and host Hungarian solver are options no preset of the port runs.)"""
    cost = radar_cost_matrix(gt, gt_mask, radar_output.detach(), "euclidean" if training else "nll")
    assigned = auction_assignment(cost, gt_mask)
    return torch.mean(radar_scan_loss(gt, gt_mask, radar_output, assigned)), assigned
