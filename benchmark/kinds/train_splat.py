"""Training splatfacto: ``SplatfactoTrainer.train_step`` back to back, one whole training image a
step drawn by the trainer's own seeded generator, with the preset's refine every ``refine_every``
steps left in; no log, eval or save cadence.

Set-up builds the trainer through the registry (``port.get_method(preset).setup(outputs,
device)``), holds the preset to the configuration file's ``model`` entry, writes the gaussians of
``draw_state`` (the configuration's ``state`` entry, a trained scene's state at step
``start_step``: the geometry from the scene's seed, the appearance from the run's) into it, sets its step to ``start_step`` and drives it through its first
three steps by the window's own call, recording each step's image index (the step's only draw), its
loss, the first step's rendered image and first gradient (from Adam's state: exp_avg / (1 - beta1))
and the parameters after the third. The window then runs ``train_step`` on the same object until
``seconds`` have passed, and ends when the device has finished the last step.

The reference (``reference/nrref/splatfacto.py``) follows the three recorded steps from the same
gaussians. Compared, each against ``limits/<cell>.json``: ``image_gap``, the mean absolute gap of
the first step's rendered images in [0, 1] units; ``loss_gap``, the largest relative gap of a
step's loss; ``grad_gap``, the worst parameter group's relative L2 gap of the first gradient;
``change_gap``, the worst group's gap of the parameters' change over the three steps, each element
weighted by the magnitude of its reference first gradient: sum |g| |dp - dr| / sum |g| |dr|.

The change is weighted because Adam moves an element by up to its rate whatever its gradient's size.
Most of the 1,048,576 gaussians lie behind a tile's first opaque layers or in its corners, and their
gradients (under Adam's eps of 1e-8) are at the level of float32 rounding: the card's atomics alone
move the geometry groups' gradients by 1e-3 run to run (on an H100), so their unweighted
changes part by as much as a bf16 step's do. Weighted, each element counts by how much the step's
loss depends on it. A change's norm would not do either: it barely sees precision.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from harness import compare
from harness.runner import Cell, RunArgs, Tracer, checks, correct, free, peak_bytes, sub_seeds, sync
from harness.scene import make_scene
from harness.splat_count import SplatLayout
from reference.nrref.splatfacto import NAMES, SplatReference, settings_of

STEPS_CHECKED = 3
# the configuration file's model entry, as the preset's config names each setting
MODEL_FIELDS = ("max_gaussians", "tile_top_k", "sh_degree", "refine_every", "warmup_steps", "stop_split_at",
                "reset_alpha_every", "cull_alpha_thresh", "cull_scale_thresh", "densify_grad_thresh", "ssim_lambda")
TRAINER_FIELDS = ("lr_means", "lr_scales", "lr_quats", "lr_opacity", "lr_rgb", "max_num_iterations")


def _preset(port, config: Dict):
    """The registry's preset, held to the configuration file's ``model`` entry."""
    cfg = port.get_method(config["preset"])
    spec = config["model"]
    stated = {k: getattr(cfg.model, k) for k in MODEL_FIELDS}
    stated.update({k: getattr(cfg, k) for k in TRAINER_FIELDS})
    stated["lr_sh_rest"] = cfg.lr_rgb / 20.0
    wrong = {k: (v, spec[k]) for k, v in stated.items() if spec[k] != v}
    if wrong:
        raise ValueError(f"preset {config['preset']!r} differs from its configuration file (preset, file): {wrong}")
    return cfg


def _morton(q: torch.Tensor) -> torch.Tensor:
    """Z-order codes of non-negative integer cells [n, 3] (21 bits an axis)."""
    def spread(x):
        x = x & 0x1FFFFF
        x = (x | x << 32) & 0x1F00000000FFFF
        x = (x | x << 16) & 0x1F0000FF0000FF
        x = (x | x << 8) & 0x100F00F00F00F00F
        x = (x | x << 4) & 0x10C30C30C30C30C3
        return (x | x << 2) & 0x1249249249249249

    return spread(q[:, 0]) | spread(q[:, 1]) << 1 | spread(q[:, 2]) << 2


def knn3_spacing(points: torch.Tensor, window: int, cell: float) -> torch.Tensor:
    """Each point's mean distance to its 3 nearest others, searched among the ``window`` points on
    either side along two Z-order curves of ``cell``-sized cells, half a cell apart (an upper bound of
    the exact distance, exact where the neighbours fall in the window)."""
    n = len(points)
    best = torch.full((n, 3), float("inf"), device=points.device)
    lo = points.min(0).values
    for shift in (0.0, 0.5):
        q = ((points - lo) / cell + shift).long().clamp(0, (1 << 21) - 1)
        order = torch.argsort(_morton(q))
        s = points[order]
        cand = [best[order]]
        for o in range(1, window + 1):
            d = (s[o:] - s[:-o]).norm(dim=1)
            pad = torch.full((o,), float("inf"), device=points.device)
            cand += [torch.cat([d, pad])[:, None], torch.cat([pad, d])[:, None]]
        best[order] = torch.cat(cand, 1).topk(3, dim=1, largest=False).values
    return best.mean(1)


def draw_state(scene, spec: Dict, model: Dict, scene_seed: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The gaussians of a trained scene on ``device``, every slot alive. Their geometry belongs to the
    scene and is drawn from ``scene_seed``, the same in every run: the means at the scene's lidar
    returns (world frame, no non-returns), each repeated to fill the capacity and jittered by
    ``jitter`` times its spacing among the returns; log-scales the log of each mean's spacing among
    the means, as splatfacto initializes them (``knn3_spacing``, at least ``min_spacing``), plus a
    normal offset of std ``log_scale_std`` on each axis (a trained scene's gaussians are anisotropic,
    and an isotropic one's rotation has no gradient); random unit quaternions. Their appearance is
    drawn from the run's ``seed``: opacities uniform in ``opacity``, DC colour logits normal of std
    ``rgb_logit_std``, SH rest bands normal of std ``sh_std``. (The geometry sets the tiles' pair
    counts and so the step's work and memory, which are then the same in every run.)"""
    geo = torch.Generator(device=device).manual_seed(int(scene_seed))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    window, cell = int(spec["knn_window"]), float(spec["knn_cell"])
    points = torch.cat([torch.as_tensor(p[np.linalg.norm(p[:, :3], axis=1) < 1e3, :3] @ l2w[:3, :3].T + l2w[:3, 3],
                                        dtype=torch.float32) for p, l2w in zip(scene.lidar_points,
                                                                                 scene.lidar_to_worlds)]).to(device)
    G = int(model["max_gaussians"])
    src = torch.arange(G, device=device) % len(points)
    jitter = float(spec["jitter"]) * knn3_spacing(points, window, cell)[src, None]
    means = points[src] + jitter * torch.randn(G, 3, generator=geo, device=device)
    spacing = knn3_spacing(means, window, cell).clamp(min=float(spec["min_spacing"]))[:, None]
    log_scales = torch.log(spacing) + float(spec["log_scale_std"]) * torch.randn(G, 3, generator=geo, device=device)
    quats = torch.randn(G, 4, generator=geo, device=device)
    lo, hi = spec["opacity"]
    opacity = lo + (hi - lo) * torch.rand(G, 1, generator=gen, device=device)
    bands = (int(model["sh_degree"]) + 1) ** 2 - 1
    return {
        "means": means,
        "log_scales": log_scales,
        "quats": quats / quats.norm(dim=1, keepdim=True),
        "opacity_logits": torch.log(opacity / (1 - opacity)),
        "rgb_logits": float(spec["rgb_logit_std"]) * torch.randn(G, 3, generator=gen, device=device),
        "sh_rest": float(spec["sh_std"]) * torch.randn(G, 3 * bands, generator=gen, device=device),
    }


def _first_grads(trainer) -> Dict[str, torch.Tensor]:
    """Each group's first gradient on the host, from Adam's state after one step (zero where the
    step gave the group no gradient, and Adam no state)."""
    out = {}
    for name, opt in trainer.optimizer.optimizers.items():
        group = opt.param_groups[0]
        param = group["params"][0]
        avg = opt.state[param].get("exp_avg", torch.zeros_like(param))
        out[name] = (avg / (1.0 - group["betas"][0])).cpu()
    return out


def _gap(p: torch.Tensor, r: torch.Tensor) -> float:
    r = r.double()
    return float((p.to(r.device).double() - r).norm() / r.norm().clamp(min=1e-30))


def _weighted_gap(p: torch.Tensor, r: torch.Tensor, weight: torch.Tensor) -> float:
    """sum |w| |p - r| / sum |w| |r|."""
    w = weight.abs().double()
    return float((w * (p.double() - r.double()).abs()).sum() / (w * r.double().abs()).sum().clamp(min=1e-300))


def _numbers(side: Dict, ref: Dict, before: Dict) -> Tuple[Dict[str, float], Dict[str, str]]:
    """(image_gap, loss_gap, grad_gap and change_gap of one side against the reference; the worst
    group of each group gap)."""
    grads = {k: _gap(side["grads"][k], ref["grads"][k]) for k in NAMES}
    changes = {k: _weighted_gap(side["after"][k].to(before[k].device) - before[k], ref["after"][k] - before[k],
                                ref["grads"][k]) for k in NAMES}
    g, c = max(grads, key=grads.get), max(changes, key=changes.get)
    image = float((side["image"].to(ref["image"].device) - ref["image"]).abs().mean())
    return ({"image_gap": image, "loss_gap": compare.loss_gap(side["losses"], ref["losses"]), "grad_gap": grads[g],
             "change_gap": changes[c]}, {"grad_gap": g, "change_gap": c})


def _reference(config: Dict, scene, device, lowered: bool = False) -> SplatReference:
    H, W = scene.image_size
    H, W = H // 16 * 16, W // 16 * 16
    w2cs = np.stack([np.linalg.inv(np.vstack([c, [0, 0, 0, 1]]))[:3] for c in scene.camera_to_worlds])
    return SplatReference(settings_of(config["model"]), scene.images[:, :H, :W], w2cs.astype(np.float32),
                          scene.intrinsics, device, lowered=lowered)


def run(cell: Cell, args: RunArgs, port) -> Dict:
    config, device, seeds = cell.config, args.device, sub_seeds(args.seed)
    cfg = _preset(port, config)
    cfg.seed = seeds["sampler"]
    scene = make_scene(config["scene"])
    trainer = cfg.setup(port.port_outputs(scene), device)
    state = draw_state(scene, config["state"], config["model"], config["scene"]["seed"], seeds["weights"], device)
    with torch.no_grad():
        for k, v in trainer.model.params.items():
            v.copy_(state[k])
        trainer.model.alive.fill_(True)
    state = {k: v.to("cpu", copy=True) for k, v in state.items()}  # the reference's start, off the card meanwhile
    start = int(config["state"]["start_step"])
    trainer.step = start

    images, losses, draw = [], [], trainer.next_image

    def recording_draw():
        images.append(draw())
        return images[-1]

    trainer.next_image = recording_draw
    for k in range(STEPS_CHECKED):
        loss, metrics = trainer.train_step()
        losses.append(loss["total"].item())
        if k == 0:
            first_image, first_grads = metrics["rgb"].cpu(), _first_grads(trainer)
    del trainer.next_image  # the instance's attribute goes; the class's method serves the window
    program = {"losses": losses, "grads": first_grads, "image": first_image,
               "after": {k: v.detach().to("cpu", copy=True) for k, v in trainer.model.params.items()}}
    sync(device)
    setup_s = time.time() - args.started
    mc = cfg.model
    layout = SplatLayout(gaussians=mc.max_gaussians, height=trainer.H, width=trainer.W, top_k=mc.tile_top_k,
                         sh_degree=mc.sh_degree)

    totals = []
    if args.trace:
        tracer = Tracer(args)
        units = int(cell.traffic["trace_units"])
        with tracer:
            t0 = time.perf_counter()
            for _ in range(units):
                totals.append(trainer.train_step()[0]["total"])
            sync(device)
            window = time.perf_counter() - t0
        traced = tracer.finish(cell, units, window, layout, None, 0.0)
    else:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            totals.append(trainer.train_step()[0]["total"])
        sync(device)
        window = time.perf_counter() - t0
    peak = peak_bytes(device)
    failed = int(sum(not bool(torch.isfinite(t)) for t in totals))
    del trainer, draw, recording_draw, metrics, loss
    free()

    state = {k: v.to(device) for k, v in state.items()}
    alive = torch.ones(len(state["means"]), dtype=torch.bool, device=device)
    ref = _reference(config, scene, device).follow(state, alive, images, start)
    numbers, worst = _numbers(program, ref, state)
    control = None
    if args.control:
        low = _reference(config, scene, device, lowered=True).follow(state, alive, images, start)
        control = _numbers(low, ref, state)[0]

    found = checks(numbers, cell.limits)
    result = {"correct": correct(found), "attempted": len(totals), "failed": failed, "peak": peak, "checks": found,
              "control": control, "worst_leaf": worst}
    if args.trace:
        result.update(traced)
    else:
        result["metrics"] = {"train_rays_per_s": len(totals) * layout.pixels / window, "setup_s": setup_s,
                             "peak_mem_gb": peak / 1e9}
    return result
