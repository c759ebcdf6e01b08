"""Training nerfacto: ``NerfactoTrainer.train_step`` back to back with the datamanager's prefetch thread
on, the preset's batch (``num_rgb_patches`` seeded patches of ``patch_size`` x ``patch_size`` pixels, one
ray a pixel), no log, eval or save cadence.

Set-up builds the trainer through the registry (``port.get_method(preset).setup(outputs, device)``),
holds the preset to the configuration file's ``model`` entry, writes the run's weights into it (the
benchmark's weight rules, ``harness/weights.py``, on the field and on each proposal network with a seed
of its own, the hash tables U(-1, 1) times ``weights.hash_table_scale``; the pose adjustment normal of
std ``state.pose_std``), sets its step to ``state.start_step`` and drives it through its first three
steps by the window's own call and feed, recording each step's host batch, the state of its generator
before the step, its loss, the first step's rendered colours, the first gradient (from Adam's state:
exp_avg / (1 - beta1)) and the parameters after the third. The window then runs ``train_step`` on the
same object until ``seconds`` have passed, and ends when the device has finished the last step.

The reference (``reference/nrref/nerfacto.py``) follows the three recorded steps from the same
parameters. Compared, each against ``limits/<cell>.json``: ``rgb_gap``, the mean absolute gap of the
first step's rendered colours in [0, 1] units; ``loss_gap``, the largest relative gap of a step's loss;
``grad_gap``, the worst parameter's relative L2 gap of the first gradient; ``change_gap``, the worst
parameter's gap of the change over the three steps, each element weighted by the magnitude of its
reference first gradient: sum |g| |dp - dr| / sum |g| |dr|. The change is weighted, as in
``train_splat.py``, because Adam moves an element by up to its rate whatever its gradient's size: the
hash-table rows that a step's samples reach only at a cell's far corner get gradients at float32's
rounding level, and their unweighted changes part by as much as a bf16 step's.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from harness import compare
from harness.nerfacto_count import layout_of
from harness.runner import Cell, RunArgs, Tracer, checks, correct, free, peak_bytes, sub_seeds, sync
from harness.scene import make_scene
from harness.weights import fill_weights
from reference.nrref.nerfacto import NerfactoRun, settings_of

STEPS_CHECKED = 3
TRAINER_FIELDS = ("lr_init", "lr_final", "warmup_steps", "max_num_iterations", "num_rgb_patches", "patch_size")
# the modules whose weights the benchmark's rules draw, each from a seed of its own
DRAWN = ("field", "proposal_0", "proposal_1")


def _plain(value):
    """Tuples as lists, so that a preset's value compares with a JSON file's."""
    if isinstance(value, (tuple, list)):
        return [_plain(v) for v in value]
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value


def _preset(port, config: Dict):
    """The registry's preset, held to the configuration file's ``model`` entry."""
    cfg = port.get_method(config["preset"])
    spec = config["model"]
    stated = {k: getattr(cfg.model, k) for k in spec if k not in TRAINER_FIELDS}
    stated["camera_optimizer"] = cfg.model.camera_optimizer.mode
    stated.update({k: getattr(cfg, k) for k in TRAINER_FIELDS})
    wrong = {k: (v, spec[k]) for k, v in stated.items() if _plain(v) != spec[k]}
    if wrong:
        raise ValueError(f"preset {config['preset']!r} differs from its configuration file (preset, file): {wrong}")
    return cfg


@torch.no_grad()
def draw_weights(model, seed: int, table_scale: float, pose_std: float) -> None:
    """The run's weights, written into ``model`` (the port's ``NerfactoModel``)."""
    seeds = np.random.SeedSequence(int(seed)).generate_state(len(DRAWN) + 1)
    for name, s in zip(DRAWN, seeds):
        fill_weights(getattr(model, name), int(s), table_scale)
    pose = model.camera_optimizer.pose_adjustment
    gen = torch.Generator(device=pose.device).manual_seed(int(seeds[-1]))
    pose.copy_(pose_std * torch.randn(pose.shape, generator=gen, device=pose.device))


def _first_grads(trainer, names: Dict[int, str]) -> Dict[str, torch.Tensor]:
    """Each parameter's first gradient on the host, from Adam's state after one step."""
    out = {}
    for opt in trainer.optimizer.optimizers.values():
        for group in opt.param_groups:
            for p in group["params"]:
                avg = opt.state[p].get("exp_avg", torch.zeros_like(p))
                out[names[id(p)]] = (avg / (1.0 - group["betas"][0])).cpu()
    return out


def _gap(p: torch.Tensor, r: torch.Tensor) -> float:
    r = r.double()
    return float((p.to(r.device).double() - r).norm() / r.norm().clamp(min=1e-30))


def _weighted_gap(p: torch.Tensor, r: torch.Tensor, weight: torch.Tensor) -> float:
    """sum |w| |p - r| / sum |w| |r|."""
    w = weight.abs().double()
    return float((w * (p.double() - r.double()).abs()).sum() / (w * r.double().abs()).sum().clamp(min=1e-300))


def _numbers(side: Dict, ref: Dict, before: Dict) -> Tuple[Dict[str, float], Dict[str, str]]:
    """(rgb_gap, loss_gap, grad_gap and change_gap of one side against the reference; the worst
    parameter of each parameter gap)."""
    names = sorted(ref["grads"])
    grads = {k: _gap(side["grads"][k], ref["grads"][k]) for k in names}
    changes = {k: _weighted_gap(side["after"][k].to(before[k].device) - before[k], ref["after"][k] - before[k],
                                ref["grads"][k]) for k in names}
    g, c = max(grads, key=grads.get), max(changes, key=changes.get)
    rgb = float((side["rgb"].to(ref["rgb"].device) - ref["rgb"]).abs().mean())
    return ({"rgb_gap": rgb, "loss_gap": compare.loss_gap(side["losses"], ref["losses"]), "grad_gap": grads[g],
             "change_gap": changes[c]}, {"grad_gap": g, "change_gap": c})


def run(cell: Cell, args: RunArgs, port) -> Dict:
    config, device, seeds = cell.config, args.device, sub_seeds(args.seed)
    cfg = _preset(port, config)
    cfg.seed = seeds["sampler"]
    scene = make_scene(config["scene"])
    trainer = cfg.setup(port.port_outputs(scene), device)
    draw_weights(trainer.model, seeds["weights"], float(config["weights"]["hash_table_scale"]),
                 float(config["state"]["pose_std"]))
    start = int(config["state"]["start_step"])
    trainer.step = start
    params = {k: v.detach().to("cpu", copy=True) for k, v in trainer.model.state_dict().items()}

    batches, states, losses, colors = [], [], [], []
    feed, loss_fn = trainer.dm.next_train, trainer.loss

    def recording_feed():
        batches.append(feed())
        return batches[-1]

    def recording_loss(*a, **k):
        out = loss_fn(*a, **k)
        if not colors:
            colors.append(out[3]["rgb"].detach().to("cpu", copy=True))
        return out

    trainer.dm.next_train, trainer.loss = recording_feed, recording_loss
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    for k in range(STEPS_CHECKED):
        states.append(trainer.generator.get_state())
        loss, _ = trainer.train_step()
        losses.append(loss["total"].item())
        if k == 0:
            first_grads = _first_grads(trainer, names)
    del trainer.dm.next_train, trainer.loss  # the instances' attributes go; the classes' methods serve the window
    program = {"losses": losses, "grads": first_grads, "rgb": colors[0],
               "after": {n: p.detach().to("cpu", copy=True) for n, p in trainer.model.named_parameters()}}
    sync(device)
    setup_s = time.time() - args.started
    layout = layout_of(config["model"])

    totals: List[torch.Tensor] = []
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
    trainer.shutdown()
    del trainer, feed, loss_fn, recording_feed, recording_loss, loss
    free()

    settings = settings_of(config["model"])
    before = {k: v.to(device) for k, v in params.items()}
    ref = NerfactoRun(settings, scene, device).follow(params, batches, states, start)
    numbers, worst = _numbers(program, ref, before)
    control = None
    if args.control:
        low = NerfactoRun(settings, scene, device, lowered=True).follow(params, batches, states, start)
        control = _numbers(low, ref, before)[0]

    found = checks(numbers, cell.limits)
    result = {"correct": correct(found), "attempted": len(totals), "failed": failed, "peak": peak, "checks": found,
              "control": control, "worst_leaf": worst}
    if args.trace:
        result.update(traced)
    else:
        result["metrics"] = {"train_rays_per_s": len(totals) * layout.rays / window, "setup_s": setup_s,
                             "peak_mem_gb": peak / 1e9}
    return result
