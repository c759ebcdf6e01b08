"""Training: ``Trainer.train_step`` back to back with the datamanager's prefetch thread on, the
preset's batch, no eval, log or save cadence. The batches are the port's datamanager's, whose
sampler the seed seeds; there are no requests to draw.

Set-up builds the trainer, writes the seed's weights into it and drives it through its first three
steps by the window's own call and feed, recording each step's host batch, the state of its
generator, its loss, the first gradient (from Adam's state) and the parameters after the third; then
the window runs ``train_step`` back to back on the same object until ``seconds`` have passed, and
ends when the device has finished the last step. The reference follows the three recorded steps
from the same weights with a plain Adam (``harness/compare.py`` says what is compared).
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import torch

from harness import compare, roofline
from harness.runner import (Cell, RunArgs, Tracer, checks, correct, free, peak_bytes, reference_config,
                            reference_pipeline, sub_seeds, sync)
from harness.scene import make_scene
from harness.weights import fill_weights
from reference.nrref import lowp
from reference.nrref.models.neuradar import SegmentLayout
from reference.nrref.pipeline import ReferencePipeline

STEPS_CHECKED = 3


def _first_grad_norms(optimizer, names: Dict[int, str]) -> Dict[str, float]:
    """Each trained leaf's first gradient norm, from Adam's state after one step: exp_avg / (1 - beta1)."""
    out = {}
    for opt in optimizer.optimizers.values():
        for group in opt.param_groups:
            b1 = group["betas"][0]
            for p in group["params"]:
                state = opt.state.get(p, {})
                out[names[id(p)]] = (float(state["exp_avg"].double().norm()) / (1.0 - b1)
                                     if "exp_avg" in state else 0.0)
    return out


def _follow(ref: ReferencePipeline, config: Dict, batches, states, device) -> Dict:
    """The reference through the recorded steps from the seed's weights: losses, first gradient
    norms and the parameters after the last step."""
    opt = ref.optimizer(config["model"]["max_steps"])
    names = {id(p): n for n, p in ref.model.named_parameters()}
    losses, grads = [], None
    for k, (batch, state) in enumerate(zip(batches, states)):
        gen = torch.Generator(device=device)
        gen.set_state(state)
        ref.model.train()
        opt.zero_grad()
        total, _ = ref.train_loss(batch, gen)
        total.backward()
        opt.step(k)
        losses.append(total.item())
        if k == 0:
            grads = _first_grad_norms(opt, names)
    after = {n: p.detach().clone() for n, p in ref.model.named_parameters() if n in grads}
    return {"losses": losses, "grads": grads, "after": after}


def _numbers(losses, grads, after_cpu, ref: Dict, before) -> Tuple[Dict[str, float], Dict[str, str]]:
    """(loss_gap, grad_gap and change_gap of one side against the reference ``ref``; the worst leaf
    of each leaf gap)."""
    change_p = {n: float((after_cpu[n].to(before[n].device) - before[n]).double().norm()) for n in before}
    change_r = {n: float((ref["after"][n] - before[n]).double().norm()) for n in before}
    g, g_leaf = compare.worst_leaf_gap(grads, ref["grads"])
    c, c_leaf = compare.worst_leaf_gap(change_p, change_r, compare.moving_leaves(ref["grads"]))
    return ({"loss_gap": compare.loss_gap(losses, ref["losses"]), "grad_gap": g, "change_gap": c},
            {"grad_gap": g_leaf, "change_gap": c_leaf})


def run(cell: Cell, args: RunArgs, port) -> Dict:
    config, device, seeds = cell.config, args.device, sub_seeds(args.seed)
    scale = float(config["weights"]["hash_table_scale"])
    scene = make_scene(config["scene"])
    trainer = port.build_trainer(config, scene, seeds["sampler"], device)
    drawn = fill_weights(trainer.model, seeds["weights"], scale)
    dm = trainer.pipeline.datamanager
    batches, states, losses = [], [], []
    feed = dm.next_train

    def recording_feed():
        batches.append(feed())
        return batches[-1]

    dm.next_train = recording_feed
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    for k in range(STEPS_CHECKED):
        states.append(trainer.generator.get_state())
        loss, _ = trainer.train_step()
        losses.append(loss["total"].item())
        if k == 0:
            prog_grads = _first_grad_norms(trainer.optimizer, names)
    del dm.next_train  # the instance's attribute goes; the class's method serves the window
    prog_after = {n: p.detach().to("cpu", copy=True) for n, p in trainer.model.named_parameters() if n in prog_grads}
    sync(device)
    setup_s = time.time() - args.started
    rays = trainer.pipeline.layout.total
    cfg = reference_config(config)
    layout = trainer.pipeline.layout
    ref_layout = SegmentLayout(num_cam=layout.num_cam, num_lidar=layout.num_lidar,
                               num_radar_scans=layout.num_radar_scans, rays_per_scan=layout.rays_per_scan,
                               patch_size=layout.patch_size)

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
        traced = tracer.finish(cell, units, window, ref_layout, cfg,
                               roofline.train_step_flops(cfg, ref_layout, cfg.rgb_upsample_factor))
    else:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            totals.append(trainer.train_step()[0]["total"])
        sync(device)
        window = time.perf_counter() - t0
    peak = peak_bytes(device)
    failed = int(sum(not bool(torch.isfinite(t)) for t in totals))
    trainer.shutdown()
    del trainer, dm, feed, recording_feed
    free()

    ref = reference_pipeline(cell, scene, seeds, drawn, device)
    before = {n: p.detach().clone() for n, p in ref.model.named_parameters() if n in prog_grads}
    r = _follow(ref, config, batches, states, device)
    numbers, worst = _numbers(losses, prog_grads, prog_after, r, before)
    control = None
    if args.control:
        fill_weights(ref.model, seeds["weights"], scale)
        with lowp.float8_weights():
            c = _follow(ref, config, batches, states, device)
        p_after = {n: t.to("cpu") for n, t in c["after"].items()}
        control = _numbers(c["losses"], c["grads"], p_after, r, before)[0]

    found = checks(numbers, cell.limits)
    result = {"correct": correct(found), "attempted": len(totals), "failed": failed, "peak": peak, "checks": found,
              "control": control, "worst_leaf": worst}
    if args.trace:
        result.update(traced)
    else:
        result["metrics"] = {"train_rays_per_s": len(totals) * rays / window, "setup_s": setup_s,
                             "peak_mem_gb": peak / 1e9}
    return result
