"""Radar loss: the multi-Bernoulli loss (NLL or euclidean) with a set association, the DETR set
loss of the set decoder, and the eval-side point sampling and point-cloud distances (port of the
JAX package's model_components/radar_utils.py).

Ground-truth scans are padded to [num_scans, max_gt, 3] with a validity mask. Each GT point is
assigned a distinct component (a multi-Bernoulli component or a set query) by one of two solvers:

* "auction": a Jacobi auction on the device, batched over scans, for a fixed number of rounds.
  The JAX package's while_loop stops once every valid row is assigned, and a round with no
  unassigned row changes nothing, so the fixed count gives the same answer without a host sync
  per round. With more valid rows than columns no round leaves every row assigned, and the JAX
  loop too runs all its rounds.
* "hungarian": scipy's exact ``linear_sum_assignment`` on the host, one scan at a time over its
  masked rows, as the JAX package's ``pure_callback`` runs it. Each call copies the cost to the
  host, which waits for the device (a sync), and copies the assignment back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from neuradar_tpu_torch.utils import trace

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
    """Jacobi auction over a batch: cost [N, P, O], row_mask [N, P] -> assigned [N, P] long, the
    column of each valid row, -1 for unassigned or masked rows. Each round every unassigned row
    bids for its best column; each column goes to its highest bidder, evicting the previous owner.
    With more valid rows than columns (P > O) the surplus rows end at -1 after ``max_iters``
    rounds, as in the JAX package."""
    N, P, O = cost.shape
    device = cost.device
    benefit = -cost
    with trace.host_sync("auction"):
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
        with trace.host_sync("auction"):  # the value -1 is copied to the device
            assigned[scans.expand(N, O), evict] = -1
        winner = torch.where(won, best_person, torch.full_like(best_person, P))
        assigned[scans.expand(N, O), winner] = cols.expand(N, O)
        owner = torch.where(won, best_person, owner)
        price = torch.where(won, best_bid, price)
    assigned = assigned[:, :P]
    return torch.where(row_mask, assigned, torch.full_like(assigned, -1))


def _hungarian_host(cost: np.ndarray, row_mask: np.ndarray) -> np.ndarray:
    """Exact assignment of a batch of scans on the host: cost [N, P, O], row_mask [N, P] -> [N, P]
    int64, -1 for masked rows and for the rows left over when a scan has more rows than columns."""
    from scipy.optimize import linear_sum_assignment

    out = np.full(cost.shape[:-1], -1, np.int64)
    for b in range(cost.shape[0]):
        rows_b = np.flatnonzero(row_mask[b])
        if len(rows_b) == 0:
            continue
        rows, cols = linear_sum_assignment(cost[b][rows_b])
        out[b, rows_b[rows]] = cols
    return out


def hungarian_assignment(cost: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """scipy's exact Hungarian per scan: cost [N, P, O], row_mask [N, P] -> assigned [N, P] long
    on the cost's device. The copies to the host and back (each a sync on the card) are the spans
    ``host_sync/hungarian``, scipy's solve the span ``hungarian/solve``; each call counts
    ``hungarian_calls`` (``utils/trace.py``)."""
    with trace.host_sync("hungarian"):
        cost_np = cost.detach().float().cpu().numpy()
    with trace.host_sync("hungarian"):
        mask_np = row_mask.cpu().numpy()
    with trace.span("hungarian/solve"):
        out = _hungarian_host(cost_np, mask_np)
    trace.count("hungarian_calls")
    with trace.host_sync("hungarian"):
        return torch.from_numpy(out).to(cost.device)


def solve_assignment(cost: torch.Tensor, row_mask: torch.Tensor, method: str = "auction") -> torch.Tensor:
    """Batched assignment: cost [N, P, O], row_mask [N, P] -> [N, P] long, -1 where unassigned."""
    if method == "auction":
        return auction_assignment(cost, row_mask)
    if method == "hungarian":
        return hungarian_assignment(cost, row_mask)
    raise ValueError(method)


def radar_scan_loss(gt: torch.Tensor, gt_mask: torch.Tensor, prediction: torch.Tensor,
                    assigned: torch.Tensor, loss_type: str = "nll") -> torch.Tensor:
    """Per-scan multi-Bernoulli loss [N] given the assignment: every component pays -log(1 - r),
    an associated one instead -log(r) plus its point error, the Laplace NLL ('nll') or the distance
    to its GT point ('euclidean'); normalized by n_mb."""
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
    if loss_type == "nll":
        assoc_loss = -laplace_log_prob(gt_for_mb, mean, scale).sum(-1) - torch.log(r)
    elif loss_type == "euclidean":
        assoc_loss = torch.linalg.vector_norm(mean - gt_for_mb, dim=-1) - torch.log(r)
    else:
        raise ValueError(loss_type)
    return torch.sum(torch.where(is_assoc, assoc_loss, unassoc_loss), dim=-1) / n_mb


def calculate_radar_loss(gt: torch.Tensor, gt_mask: torch.Tensor, radar_output: torch.Tensor,
                         loss_type: str = "nll", training: bool = True,
                         assignment: str = "auction") -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean radar loss over scans and the assignment [N, G]: gt [N, G, 3], gt_mask [N, G],
    radar_output [N, n_mb, 7]. The association cost is euclidean in training whatever the loss
    type, the loss type's own in eval, and carries no gradient."""
    cost = radar_cost_matrix(gt, gt_mask, radar_output.detach(), "euclidean" if training else loss_type)
    assigned = solve_assignment(cost, gt_mask, assignment)
    return torch.mean(radar_scan_loss(gt, gt_mask, radar_output, assigned, loss_type)), assigned


def detr_set_loss(gt: torch.Tensor, gt_mask: torch.Tensor, radar_output: torch.Tensor, cost_class: float = 1.0,
                  cost_point: float = 0.2, eos_coef: float = 0.1, point_mult: float = 1.0,
                  assignment: str = "auction") -> Tuple[torch.Tensor, torch.Tensor]:
    """DETR's set criterion on radar point sets: mean loss over scans and the assignment [N, G].

    The matching, without gradient, minimizes cost_class * (-existence) + cost_point * L1(xyz, gt);
    the existence BCE weights the unmatched queries by ``eos_coef``; the L1 point loss is taken over
    the matched pairs and divided by their count. gt [N, G, 3], gt_mask [N, G], radar_output
    [N, Q, 7]."""
    ep, xyz = radar_output[..., 0], radar_output[..., 1:4]
    N, G, _ = gt.shape
    Q = ep.shape[-1]
    with torch.no_grad():
        l1 = torch.abs(gt[:, :, None, :] - xyz[:, None, :, :]).sum(-1)  # [N, G, Q]
        cost = torch.where(gt_mask[..., None], cost_class * (-ep)[:, None, :] + cost_point * l1,
                           torch.zeros_like(l1))
    assigned = solve_assignment(cost, gt_mask, assignment)
    valid = (assigned >= 0) & gt_mask
    matched = torch.zeros((N, Q + 1), dtype=torch.bool, device=gt.device)
    matched.scatter_(1, torch.where(valid, assigned, torch.full_like(assigned, Q)), True)
    matched = matched[:, :Q]
    t = matched.to(ep.dtype)
    bce = -(t * torch.log(ep + EPS) + (1.0 - t) * torch.log1p(-ep + EPS))
    w = torch.where(matched, torch.ones_like(ep), torch.full_like(ep, eos_coef))
    loss_exist = torch.sum(w * bce, dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=EPS)
    sel = torch.gather(xyz, 1, torch.clamp(assigned, min=0)[..., None].expand(N, G, 3))
    l1 = torch.abs(sel - gt).sum(-1)
    loss_point = (torch.sum(torch.where(valid, l1, torch.zeros_like(l1)), dim=-1)
                  / torch.clamp(valid.sum(-1), min=1))
    return torch.mean(loss_exist + point_mult * loss_point), assigned


# ---------------------------------------------------------------------------- eval: point sampling

# the open interval of the Laplace sampler's uniform draws, as the JAX package's
LAPLACE_U_LOW, LAPLACE_U_HIGH = -0.5 + 1e-6, 0.5 - 1e-6


def nll_uniforms(n_mb: int, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two uniform draws of one 'nll' sample, on the generator's device: U[0, 1) [n_mb] for the
    existence draws and U[LAPLACE_U_LOW, LAPLACE_U_HIGH) [n_mb, 3] for the Laplace positions."""
    dev = generator.device
    u_exist = torch.rand((n_mb,), generator=generator, device=dev)
    u_loc = LAPLACE_U_LOW + (LAPLACE_U_HIGH - LAPLACE_U_LOW) * torch.rand((n_mb, 3), generator=generator, device=dev)
    return u_exist, u_loc


def sample_radar_points(radar_output: torch.Tensor, loss_type: str,
                        uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, threshold: float = 0.5,
                        max_detections: int = 1000) -> Tuple[torch.Tensor, torch.Tensor]:
    """A point cloud drawn from one scan's multi-Bernoulli output [n_mb, 7]: points [n_mb, 3] and
    the keep mask [n_mb]. Only the ``max_detections`` components of highest existence can be kept.

    'euclidean' is deterministic: the means of components with r > threshold. 'nll' keeps a
    component where u_exist < r and moves it by a Laplace draw (inverse CDF of u_loc); the
    uniforms come from ``nll_uniforms`` or, in a test, from the JAX package's generator."""
    r, mean, scale = mb_split(radar_output)
    n_mb = r.shape[0]
    order = torch.argsort(-r, stable=True)  # jnp.argsort is stable
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n_mb, device=r.device)
    in_budget = rank < max_detections
    if loss_type == "euclidean":
        return mean, in_budget & (r > threshold)
    if loss_type == "nll":
        if uniforms is None:
            raise ValueError("nll sampling needs its uniform draws")
        u_exist, u_loc = (u.to(r.device) for u in uniforms)
        pts = mean - scale * torch.sign(u_loc) * torch.log1p(-2 * torch.abs(u_loc))
        return pts, (u_exist < r) & in_budget
    raise ValueError(loss_type)


# ---------------------------------------------------------------------------- eval: host metrics


def chamfer_distance_np(x: np.ndarray, y: np.ndarray) -> float:
    """Bidirectional chamfer distance between two point clouds (host numpy)."""
    if len(x) == 0 or len(y) == 0:
        return float("nan")
    d2 = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(d2.min(1)).mean() + np.sqrt(d2.min(0)).mean())


def emd_distance_np(x: np.ndarray, y: np.ndarray) -> float:
    """Earth mover's distance between two point clouds (scipy)."""
    from scipy.stats import wasserstein_distance_nd

    return float(wasserstein_distance_nd(x, y))
