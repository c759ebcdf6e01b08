"""Smoke run of the PyTorch port (neuradar_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # every phase
    python3 chip_smoke.py splat    # device, build, k5 and train_splat only
    python3 chip_smoke.py k4       # device, build and train_presets (with K4's rows) only

Phases, one line each before the final JSON line:
  1. device: requires CUDA; prints the card's name and power limit (nvidia-smi)
     and turns TF32 off for matmuls and convolutions;
  2. build: compiles the CUDA kernels from neuradar_tpu_torch/csrc with nvcc
     (one nvcc per source, all started together);
  3. kernels: K1 forward and backward (composite_sky_fwd / _bwd) and K2
     forward, with and without dropout, and backward (self_attention_fwd /
     _bwd) against their plain PyTorch versions (K1 forward's in float64) at
     the shapes the render and train paths give them, one row for each
     kernel and path, with the kernel's device time alone (``ms``,
     utils/timing.device_ms: launches queued behind a spin of the card and
     timed by one event pair) and one call's time with its host work
     (``call_ms``), the bound the card's memory rate and float32 peak put on
     each, and the device times of the plain version and of the PyTorch
     library call that computes the same function, where there is one; K1
     backward's row names the path of the kernel that ran; K2's
     rows also name their design and its tensor-core bound (3xTF32 at the
     TF32 peak), time SDPA's backward with the kernel's dropout rate (and
     without, under its own key), and check that two launches agree bit for
     bit;
     K3 (fused_composite) and P1 (row_gather), which no path runs, at the
     shapes of a render chunk and of the gather probe up to a hash grid's
     table (and a proposal grid's, on P1's scalar path; P1's rows name their
     path), with the launches of their own checks ("standalone"); and the
     kernels of the bf16 train path at its shapes: K1 forward and backward at
     one of its 8 chunks, K2 at bf16 (self_attention_bf16_fwd / _bwd, from
     csrc/attention_bf16.cu) at one radar decode group of 4 scans with
     dropout, against the plain version (which computes in float32 and
     rounds to bf16 once), with SDPA in bf16 with the same dropout as the
     library call and the tensor-core bound of the design's bf16 passes;
     and the same four at the shapes of the set decoder's train path
     (train_set: its encoder is the same transformer, so K2 gets the same
     decode group); and those of the paper's presets: train_neuradar and
     train_neurad (K1 at one of 8 chunks of their batches, K2 at bf16 on
     neuradar's), render_neuradar (K1 forward at one of 8 chunks of a
     32,768-ray render chunk) and render_radar_neuradar (K1 forward on one
     scan's 3,531 rays, K2 at bf16 on one scan, no dropout); neuradar-vod's
     paths at VoD's 4,400-ray scans: train_neuradar-vod (K1 at one of 8
     chunks of 127,744 rays, K2 at bf16 on [4, 4400, 48] with dropout),
     render_neuradar-vod and fid_neuradar-vod (K1 forward at one of 8 chunks
     of a render chunk), render_radar_neuradar-vod (K1 forward on one of 8
     chunks of a scan, K2 at bf16 on [1, 4400, 48]), and K1 forward on a
     whole scan ("standalone"); and the renders of the bf16 program's and the
     set model's phases: render_bf16 (K1 forward on the bench frame),
     render_radar_set and eval_radar_set (K1 and K2 at bf16 forward on one
     scan, and on the eval radar metrics' batch of 3 scans); and the render
     commands' path, render_cli (K1 forward at a render chunk, the float32 K2
     forward on one scan); K4, the hash-grid encode (hash_encode_fwd / _bwd,
     csrc/hash_encode.cu), has its rows from the presets' own encodes (phase
     6c);
  3b. k5: splatfacto's tile rasterizer (ops/splat.py, csrc/splat_raster.cu) at
     splatfacto-big's shapes: 1,048,576 gaussians, all alive (the lidar
     returns of the synthetic scene in VoD's camera, repeated and jittered,
     anisotropic scales, random rotations, colours and SH bands), one
     1936 x 1216 image of 9,196 tiles, 512 a tile. Rows: the binning and pair
     sort (one call, its host read included), K5 forward and backward alone
     (the kernel's device ms, one call's ms, the bound of
     benchmark/harness/splat_count.py's counts), the plain version's ms (one
     call, render_plain: a dense [tiles, G] overlap test and sort and dense
     compositing in blocks of 64 tiles), forward on the whole image and
     backward on its top 16 tile rows (the plain backward's graph in
     checkpointed blocks), each kernel against the plain version: colour,
     alpha and depth's largest gap, and each feature column's relative L2 gap
     of the gradient;
  3c. train_splat: splatfacto-big's SplatfactoTrainer on that state, from
     step 15,000 (its first step refines), 5 train steps of 2,354,176 pixels
     each, the loss finite, every parameter group changed, K5's binning (count
     and emit), forward and backward launched once a step and no other kernel;
  4. render: the neuradar-synthetic model at full width with seeded random
     weights renders 2 camera frames at 720 x 1296, one 16,384-ray lidar scan
     and 4 radar scans (decoded in the model's 4 groups of 1 scan, the shape of
     K2's render row); the launch counts show K1, K2 and K4 forward ran on
     that path;
  5. train: the neuradar-synthetic trainer at its full width and batch
     (113,840 rays a step), seeded, runs 3 train steps and one eval-loss call;
     each step prints its loss terms; every parameter group must have
     changed, and the launch counts must show K1, K2 and K4, forward and
     backward, on that path;
  6. train_bf16: the JAX package's production program,
     configs/bench_program.bench_pipeline_config("full", chunks=8) (bf16
     compute, hoisted table cast, 8 recomputed chunks, radar in 4 groups; the
     bench scene of 24 frames at 96 x 156), trained by a Trainer for 3 steps
     of 113,840 rays, then an eval loss and a camera render, both with the
     hoisted cast; K1, K2 at bf16 and K4 must have launched forward and
     backward; the render's launches are counted apart (render_bf16);
  6b. train_set: the set radar decoder (the paper's neuradar-set model
     settings: bf16, 8 chunks, the VGG loss, DETR's set loss, 300 queries
     with deep supervision, dropout 0.1, radar in 4 groups), configured as
     scripts/train.py configures neuradar-synthetic from dotted overrides,
     trained at the preset's full batch (113,840 rays, 16 radar scans of
     3,531 rays) for 3 steps with the auction and 1 with the host's
     Hungarian, then an eval loss, render_radar of one scan ([300, 7]) and
     the eval radar metrics; each step's loss terms (radar_aux_loss among
     them) and Hungarian calls (2 on the Hungarian step, none on the
     others); every parameter group, query_embed among them, must have
     changed, and K1, K2 at bf16 and K4 must have launched forward and
     backward; the render_radar's and the eval radar metrics' launches are
     counted apart (render_radar_set, eval_radar_set);
  6c. train_presets: the paper's presets of the port's registry, neuradar
     (bf16, 8 chunks, the VGG loss, camera optimizer off) and neurad (the SO3xR3
     camera optimizer on, no radar), each built as scripts/train.py builds it
     and trained by a Trainer on explicit dataparser outputs: the synthetic
     scene in ZOD's front camera (FISHEYE, six distortion coefficients, 3848 x
     1418 after the hood crop; the images rendered coarse and repeated up to
     that size), 3 steps at the preset's full batch (113,840 and 57,344 rays);
     neuradar then takes an eval loss, renders an eval frame (1282 x 472 rays
     at the x3 upsample) and a radar scan; after the steps and the eval loss
     one more step, and with radar one more eval frame and radar scan, give
     K4's rows on their own encodes, one a grid and path (each path's encodes
     must all take the kernel: one hash_encode_fwd launch an encode):
     forward rows (train, render, render_radar) bit-equal to the plain path,
     and backward rows (train) with the table's gradient against the float64
     sum of the plain path's corner gradients, the share of those that are
     exact zeros (the kernel skips them) and the positions' gradient's gap to
     plain autograd's; each with its time against its bytes bound (the
     distinct 32-byte sectors each level's lookups touch),
     the plain path's time, the library call's (index_add_ of the corner
     gradients, backward), its launches an encode; the
     launches are counted apart for the train steps with the eval loss
     (train_<preset>), neuradar's eval frame (render_neuradar) and its radar
     scan (render_radar_neuradar); K1 must launch on both presets, K2 at
     bf16 on neuradar alone, the float32 K2 on neither; the eval frame runs
     K1 and K4 forward alone, the radar scan K1, K2 at bf16 and K4 forward;
     neurad's camera_opt group must have changed and its regularizer be
     finite. train_presets_agreement: neurad's model (float32) on a tiny scene
     in the fisheye with distortion and a rolling shutter, the camera
     optimizer away from zero, one train step card against CPU by the rules
     of the agreement phase below (loss terms, every gradient,
     pose_adjustment's among them);
  6d. train_vod: neuradar-vod (neuradar on View-of-Delft's parser) as
     scripts/train.py builds it, on the synthetic scene in VoD's sensors
     (configs/bench_program.vod_sensor_scene_outputs: a 1936 x 1216 pinhole
     camera, VoD's radar FoV of 100 x 44 = 4,400 rays a scan), 3 steps of
     127,744 rays, an eval loss, an eval frame (645 x 405 rays) and a radar
     scan, as train_presets runs neuradar; then compute_fid_metrics of 2
     eval frames (8 renders each): every family finite, and its launches
     (fid_neuradar-vod: K1 and K4 forward alone); K1, K2 at bf16 and K4 on the
     train path, no float32 K2;
  7. agreement: a tiny scene rendered, and one tiny train step (loss terms and
     every gradient), through the kernels on the card against the plain
     versions on the CPU, with the same weights and the same random draws; and
     one tiny bf16 step (2 chunks, 2 radar groups, the VGG loss on) card
     against CPU, the radar association solved on one fixed cost matrix on
     both sides (a discrete choice, as in tests/test_torch_bf16_train.py);
     and the tiny set model's train step (deep supervision, DETR's loss and
     the multi-Bernoulli loss) card against CPU, in float32 with the host's
     Hungarian and in bf16 with the association pinned, by the rules of
     tests/test_torch_set_decoder.py; render_pose_agreement: the tiny
     pipeline's free-pose render (perspective, fisheye, equirectangular and
     ODS cameras, a scene time, an actor edit) card against CPU, the float
     renders to the agreement's tolerance and the uint8 images within 1;
  8. cli_train: the train command (scripts/train.py) on neuradar-synthetic at
     full width and batch, 6 steps with every eval cadence and checkpoints
     (all kept), then resumed from its checkpoints to step 8 (only the latest
     kept), then the eval command (scripts/eval.py) on the run; the events
     log must show each cadence at its steps, the checkpoints their steps,
     every metric of the three families must be finite, and K1, K2 and K4,
     forward and backward, must have launched; the run's logs stay in
     chiprun_out/runs;
  8b. cli_render: on that run, before its checkpoints are deleted, the render,
     export and texture commands, each through its main(argv) in this process:
     render.py dataset, lane-shift, actor-shift (an actor removed),
     interpolated, spiral and camera-path (a perspective frame at 720 x 1296
     and an ODS frame), render_radar.py's six commands at 2 scans, exporter.py
     pointcloud, radar-pointcloud, cameras, sdf-surface, sdf-mesh and tsdf-mesh
     at grid 128 and poisson-mesh at grid 64, texture.py on the sdf-mesh at 2
     cameras; then the closed-loop server on a free port of localhost (/info,
     /actors, an actor edit, a /render at 720 x 1296 that must return that
     PNG) and the full-frame render_pose; each command's output counts,
     every frame, scan, point cloud and mesh present and finite; the launches
     (path render_cli) must show K1, K4 and the float32 K2 forward and no
     other kernel; the outputs are deleted;
  9. learning: scripts/validate_learning.py at the tiny scale, 300 steps on
     the card, bf16 (the dtype of the JAX curve) and then float32, must print
     LEARNING CHECK: PASS; the first- and last-quarter means of both are
     printed beside those of the JAX package's CPU curve
     (artifacts/learning_curve_cpu_tiny_20k.json) over its first 300 steps;
     then 300 bf16 steps with --set-decoder and 300 with
     --radar-assignment hungarian, each of which must PASS, the latter
     beside the first 300 steps of the JAX package's Hungarian curve
     (artifacts/curve_tiny_hungarian_2500.json).
Launches are the trace counters launches/<symbol> that ops/build.check
counts, one a launch of the extern "C" launcher <symbol>; each path reads its
own from a trace.recording() window. End-to-end times are the benchmark's
(benchmark/run.py); this script times the kernels alone. The line before the
last lists every kernel as JSON, each path row with its path's launches of
its launcher; the last line is {"ok": true, "device": {...}}. Any failure
raises, and the script exits non-zero without printing them.
"""

from __future__ import annotations

import gc
import http.client
import json
import math
import re
import shutil
import struct
import subprocess
import sys
import threading
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from neuradar_tpu_torch.cameras.cameras import CameraType
from neuradar_tpu_torch.configs.bench_program import (
    ZOD_DIST,
    bench_pipeline_config,
    bench_scene_outputs,
    vod_sensor_scene_outputs,
    zod_camera_scene_outputs,
)
from neuradar_tpu_torch.configs.cli import parse_overrides
from neuradar_tpu_torch.configs.method_configs import get_method, method_configs
from neuradar_tpu_torch.data.datamanager import ADDataManagerConfig
from neuradar_tpu_torch.data.dataparsers.base import linspaced_split
from neuradar_tpu_torch.data.dataparsers.synthetic import SyntheticDataParser, SyntheticDataParserConfig
from neuradar_tpu_torch.engine.optimizers import default_optimizer_groups
from neuradar_tpu_torch.engine.trainer import Trainer, TrainerConfig
from neuradar_tpu_torch.model_components import radar_utils
from neuradar_tpu_torch.model_components.dynamic_actors import ActorEdits
from neuradar_tpu_torch.model_components.vgg import has_pretrained_weights
from neuradar_tpu_torch.models import splatfacto as sf
from neuradar_tpu_torch.models.neuradar import radar_decode_groups
from neuradar_tpu_torch.field_components import encodings
from neuradar_tpu_torch.ops import build, gather, splat
from neuradar_tpu_torch.ops.attention import (
    attention_bwd_reference,
    attention_reference,
    self_attention_bwd,
    self_attention_fwd,
)
from neuradar_tpu_torch.ops.volumetric import (
    composite_sky_bwd,
    composite_sky_bwd_path,
    composite_sky_bwd_reference,
    composite_reference,
    composite_sky_fwd,
    composite_sky_reference,
    fused_composite,
)
from neuradar_tpu_torch.ops import hash_encode as hash_encode_op
from neuradar_tpu_torch.ops.hash_encode import hash_encode_bwd, hash_encode_fwd, levels_per_launch
from neuradar_tpu_torch.ops.hash_scatter import float64_sum
from neuradar_tpu_torch.pipelines.ad_neuradar_pipeline import ADNeuRadarPipeline, ADNeuRadarPipelineConfig
from neuradar_tpu_torch.scripts import closed_loop
from neuradar_tpu_torch.scripts import eval as eval_script
from neuradar_tpu_torch.scripts import exporter as exporter_command
from neuradar_tpu_torch.scripts import render as render_command
from neuradar_tpu_torch.scripts import render_radar as render_radar_command
from neuradar_tpu_torch.scripts import texture as texture_command
from neuradar_tpu_torch.scripts import train as train_script
from neuradar_tpu_torch.scripts import validate_learning
from neuradar_tpu_torch.scripts.probe_gather import bounds_ms
from neuradar_tpu_torch.utils import meshing, trace
from neuradar_tpu_torch.utils.timing import call_ms, device_ms, kernels_ms

K1_TOL = dict(rtol=1e-5, atol=1e-6)
K2_TOL = dict(rtol=1e-4, atol=1e-5)  # online softmax sums in another order than the plain version
# backward: suffix sums and dS sums are taken in other orders than autograd through the plain versions
K1_BWD_TOL = dict(rtol=1e-4, atol=1e-5)
K2_BWD_TOL = dict(rtol=2e-4, atol=2e-5)
# K2 at bf16 against the plain version: both round one float32 result to bf16, so the two are equal
# or one bf16 unit apart (rtol 2^-7), atol for entries near 0; the float32 output before its rounding
# to the float32 sums' order and the kernel's two-pass split (tests/test_torch_attention_bf16.py
# derives these)
K2_BF16_TOL = dict(rtol=2.0**-7, atol=2.0**-12)
K2_BF16_BWD_TOL = dict(rtol=2.0**-7, atol=2.0**-10)
K2_OUT32_TOL = dict(rtol=1e-4, atol=2e-5)
TINY_TOL = dict(rtol=1e-4, atol=1e-4)
# a train step: loss terms to float32 summation order; gradients as in tests/test_torch_train.py:
# rtol 1e-3, atol 1e-4 of the parameter's largest gradient, at least 1e-7. A parameter whose
# reference gradient stays under ZERO_GRAD everywhere is taken as nought to rounding (a
# convolution's bias before batch norm has an exact gradient of 0, so both sides hold noise alone)
# and is held to |card - CPU| <= ZERO_GRAD.
TRAIN_LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
TRAIN_GRAD_RTOL = 1e-3
TRAIN_GRAD_ATOL_FLOOR = 1e-7
ZERO_GRAD = 1e-6

# the card's published peaks (H100 SXM data sheet, at 700 W): HBM bytes/s, float32 FLOP/s outside
# the tensor cores, and dense TF32 FLOP/s on them
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
# the plain versions' calls timed behind one spin of the card (see _times)
PLAIN_REPS = 1
# K2's kernels run each float32 product as three TF32 products on the tensor cores (3xTF32)
K2_DESIGN = "3xtf32-mma.sync"
# K2 at bf16: warpgroup MMAs (wgmma) on tiles that the TMA copies into shared memory, m64n64k16 where
# both operands are bf16, m64nDk16 with A from registers where one is P or dS (split hi/lo, two
# passes); its passes of 2*B*S*S*D flops: forward S, P V x 2; backward S^T, dP^T, dV x 2, dK x 2
# (dK/dV pass), S, dP, dQ x 2 (dQ pass)
K2_BF16_DESIGN = ("bf16 wgmma on TMA tiles, 2 consumer warpgroups a block (the backward's in turns), P and dS "
                  "split in two bf16 passes")
K2_BF16_FWD_PASSES = 3
K2_BF16_BWD_PASSES = 10
# the kernels of the render and train paths, by their launchers' names (a render runs K1, K2 and K4
# forward alone; the backwards run in training); K3 (composite_fwd) and P1 (row_gather) are on no path
PATH_KERNELS = {"composite_sky_fwd", "composite_sky_bwd", "self_attention_fwd", "self_attention_bwd",
                "hash_encode_fwd", "hash_encode_bwd"}
# the kernels of the bf16 train path: K1 takes float32 there too, K2 bf16
BF16_PATH_KERNELS = {"composite_sky_fwd", "composite_sky_bwd", "self_attention_bf16_fwd", "self_attention_bf16_bwd",
                     "hash_encode_fwd", "hash_encode_bwd"}
F32_K2 = {"self_attention_fwd", "self_attention_bwd"}
# the bf16 train path: the JAX package's benchmark program, 8 chunks of 14,230 rays
BF16_CHUNKS = 8
# The full-width train step runs the per-ray core unchunked, as the preset does: it fits (51 GB
# peak on an 80 GB card) and is 1.8x faster than 8 chunks recomputed in the backward pass. The
# tiny train agreement runs 2 recomputed chunks, so the checkpointed path runs on the card too.
NFF_CHUNKS = 1
TINY_NFF_CHUNKS = 2
# the radar scans the render path decodes
RENDER_RADAR_SCANS = (0, 1, 2, 3)
TRAIN_STEPS = 3
# the set radar decoder's train path: the neuradar-set model settings (bf16 at 8 chunks as the
# neuradar preset, the VGG loss, DETR's set loss) on neuradar-synthetic, as dotted overrides of the
# train command
SET_ARGV = ["--pipeline.model.compute_dtype", "bfloat16", "--pipeline.model.nff_chunks", "8",
            "--pipeline.model.loss.vgg_mult", "0.05", "--pipeline.model.radar_decoder_type", "set",
            "--pipeline.model.loss.radar_set_loss", "detr", "--pipeline.model.num_radar_queries", "300",
            "--pipeline.model.radar_set_aux_loss", "True", "--pipeline.model.radar_transformer_dropout", "0.1",
            "--pipeline.model.radar_decode_chunks", "4"]
SET_AUCTION_STEPS = 3  # then one step with the host's Hungarian
FULL_BATCH_RAYS = 113840
# the paper's presets of the registry, trained on the synthetic scene in ZOD's front camera
# (configs/bench_program.zod_camera_scene_outputs)
PRESETS = ("neuradar", "neurad")
PRESET_STEPS = 3
ZOD_SCAN_RAYS = 3531  # the ZOD radar FoV's 107 x 33 rays, the synthetic scene's
# VoD's preset, trained on the synthetic scene in VoD's camera and radar FoV
# (configs/bench_program.vod_sensor_scene_outputs): 100 x 44 = 4,400 rays a radar scan, 127,744 rays a step;
# then the shifted-view FIDs of its first VOD_FID_FRAMES eval frames
VOD_PRESET = "neuradar-vod"
VOD_SCAN_RAYS = 4400
VOD_STEP_RAYS = 40960 + 16384 + 16 * VOD_SCAN_RAYS
VOD_FID_FRAMES = 2
FID_FAMILIES = ("lane_shift_0", "lane_shift_2", "lane_shift_3", "vertical_shift_1", "actor_shift_rot",
                "actor_shift_trans")


def phase(label: str, /, **fields) -> None:
    print(json.dumps({"phase": label, **fields}), flush=True)


def _launches(snap: trace.Snapshot) -> dict:
    """The hand-written kernels' launches in a trace window, by launcher (ops/build.check's
    ``launches/<symbol>`` counters); a launcher that never launched is absent."""
    launches = {}
    for (name, _), n in snap.counters.items():
        if name.startswith("launches/"):
            symbol = name.removeprefix("launches/")
            launches[symbol] = launches.get(symbol, 0) + n
    return launches


def _kernels(launches: dict) -> set:
    """The kernels that launched, K1's backward by its name whichever of its two launchers ran."""
    return {"composite_sky_bwd" if k == "composite_sky_bwd_general" else k for k, n in launches.items() if n > 0}


def _symbol(row: dict) -> str:
    """The launcher whose launches a kernel row reports: K1 backward's by the path it ran, K3's and the
    binning's by their launchers' names, every other row's by its own name."""
    if row["name"] == "composite_sky_bwd" and row["design"] == "general":
        return "composite_sky_bwd_general"
    return {"fused_composite": "composite_fwd", "splat_bin_sort": "splat_bin_count"}.get(row["name"], row["name"])


def _times(kernel, plain, library=None, plain_syncs=False) -> dict:
    """The kernel's device time alone and one call's time with its host work; the plain version's
    and the library call's device times; and the kernel's timing run (host enqueue, spin). A plain
    version is timed one call at a time behind the spin (PLAIN_REPS): K2's launches ~170 kernels a
    call for its dropout mask, and 20 calls overflow the card's queue of pending launches. One that
    synchronises the host inside is timed by its kernels' device times (kernels_ms)."""
    ms = device_ms(kernel)
    timer = device_ms.last
    return {"ms": ms, "call_ms": call_ms(kernel),
            "plain_ms": kernels_ms(plain) if plain_syncs else device_ms(plain, reps=PLAIN_REPS),
            "plain_timer": "kernels_ms" if plain_syncs else f"device_ms, {PLAIN_REPS} call",
            "library_ms": None if library is None else device_ms(library), "timer": timer}


def _bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or float32 operations over
    the float32 peak, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _k2_bound(nbytes: float, flops: float) -> dict:
    """K2's bounds: _bound's, and the tensor-core bound of its design, 3x the flops at the TF32 peak."""
    return {**_bound(nbytes, flops), "design": K2_DESIGN, "tc_bound_ms": 3 * flops / TF32_FLOPS * 1e3}


def _k2_bf16_bound(nbytes: float, flops: float, passes: int, B: int, S: int, D: int) -> dict:
    """K2 at bf16: bytes over the memory rate or its flops (bf16 operands) over the bf16 tensor-core
    peak, and the tensor-core bound of its design, its passes of 2*B*S*S*D at that peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "design": K2_BF16_DESIGN,
            "tc_bound_ms": passes * 2 * B * S * S * D / BF16_FLOPS * 1e3}


def _max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def _assert_all_close(got, want, tol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, **tol, msg=lambda m, i=i: f"{what} output {i}: {m}")


def _group_scans(model_config, num_scans: int) -> int:
    """The scans in one radar decode group, as the model's decode_radar groups ``num_scans``."""
    return num_scans // radar_decode_groups(num_scans, model_config.radar_decode_chunks)


def _bf16_path_rows(gen, device, path: str, model_config, num_scans: int, rate: float, seed: int,
                    rays: int = FULL_BATCH_RAYS, backward: bool = True, rays_per_scan: int = ZOD_SCAN_RAYS) -> list:
    """The kernels of a bf16 path against their plain versions: K1 forward and backward at one of the
    per-ray core's chunks of ``rays`` (K1 takes float32 there; the model chunks only a batch that
    the chunk count divides), and, where the path decodes radar scans, K2 at bf16 at one radar
    decode group of scans of ``rays_per_scan`` rays (d_model 48) with dropout ``rate``. A render path
    (``backward`` False) runs the forward kernels alone."""
    rows = []
    k1 = {"route": "cuda", "source": "neuradar_tpu_torch/csrc/composite_sky.cu"}
    chunks = model_config.nff_chunks if rays % model_config.nff_chunks == 0 else 1
    R, S1, C = rays // chunks, 33, 32
    alpha = torch.rand((R, S1), generator=gen, device=device)
    feats = torch.randn((R, S1, C), generator=gen, device=device)
    got = [t.double() for t in composite_sky_fwd(alpha, feats)]
    want = composite_sky_reference(alpha.double(), feats.double())
    _assert_all_close(got, want, K1_TOL, f"K1 fwd {path}")
    rows.append({"name": "composite_sky_fwd", **k1, "replaces": "neuradar_tpu/ops/volumetric.py:100",
                 "path": path, "shape": [R, S1, C], "max_abs_err": _max_err(got, want),
                 **_times(lambda: composite_sky_fwd(alpha, feats), lambda: composite_sky_reference(alpha, feats)),
                 **_bound(4 * (R * S1 * (C + 2) + R * (C + 1)), R * S1 * (2 * C + 8))})
    if backward:
        cots = (torch.randn((R, S1), generator=gen, device=device),
                torch.randn((R, C), generator=gen, device=device), torch.randn((R, 1), generator=gen, device=device))
        got, want = composite_sky_bwd(alpha, feats, *cots), composite_sky_bwd_reference(alpha, feats, *cots)
        _assert_all_close(got, want, K1_BWD_TOL, f"K1 bwd {path}")
        rows.append({"name": "composite_sky_bwd", **k1, "replaces": "neuradar_tpu/ops/volumetric.py:125",
                     "path": path, "shape": [R, S1, C], "design": composite_sky_bwd_path(feats, cots[1]),
                     "max_abs_err": _max_err(got, want),
                     **_times(lambda: composite_sky_bwd(alpha, feats, *cots),
                              lambda: composite_sky_bwd_reference(alpha, feats, *cots), plain_syncs=True),
                     **_bound(4 * (2 * R * S1 * C + 3 * R * S1 + R * C + R), R * S1 * (3 * C + 12))})
        del cots
    del alpha, feats, got, want
    if num_scans == 0:
        return rows

    k2b = {"route": "cuda", "source": "neuradar_tpu_torch/csrc/attention_bf16.cu"}
    B, S, D = _group_scans(model_config, num_scans), rays_per_scan, 48
    bf = torch.bfloat16
    qb, kb, vb, dob = (torch.randn((B, S, D), generator=gen, device=device).to(bf) for _ in range(4))
    with trace.recording():
        out, lse, out32 = self_attention_fwd(qb, kb, vb, rate, seed, return_lse=True, return_out32=True)
        launches = _launches(trace.snapshot())
    _expect(out.dtype == bf and launches == {"self_attention_bf16_fwd": 1}, f"K2 bf16 fwd {path}: launches {launches}")
    want32 = attention_reference(qb.float(), kb.float(), vb.float(), seed, rate)
    torch.testing.assert_close(out, want32.to(bf), **K2_BF16_TOL, msg=lambda m: f"K2 bf16 fwd: {m}")
    torch.testing.assert_close(out32, want32, **K2_OUT32_TOL, msg=lambda m: f"K2 bf16 fwd out32: {m}")
    again = self_attention_fwd(qb, kb, vb, rate, seed, return_lse=True, return_out32=True)
    _expect(all(torch.equal(a, b) for a, b in zip(again, (out, lse, out32))), "K2 bf16 fwd: two launches differ")
    # timed as the path calls it: a train path keeps lse and out32 for the backward, a render path
    # writes the bf16 output alone
    extra = dict(return_lse=True, return_out32=True) if backward else {}
    rows.append({"name": "self_attention_bf16_fwd", **k2b, "replaces": "neuradar_tpu/ops/attention.py:176",
                 "path": path, "shape": [B, S, D], "dtype": "bfloat16", "dropout": rate,
                 "max_abs_err": float((out.float() - want32.to(bf).float()).abs().max()),
                 "max_abs_err_out32": float((out32 - want32).abs().max()),
                 **_times(lambda: self_attention_fwd(qb, kb, vb, rate, seed, **extra),
                          lambda: attention_reference(qb, kb, vb, seed, rate),
                          lambda: F.scaled_dot_product_attention(qb[:, None], kb[:, None], vb[:, None],
                                                                 dropout_p=rate)),
                 # q, k, v in bf16; out in bf16, out32 and lse in float32 where the path keeps them
                 **_k2_bf16_bound(2 * 3 * B * S * D + 2 * B * S * D + (4 * (B * S * D + B * S) if backward else 0),
                                  4 * B * S * S * D, K2_BF16_FWD_PASSES, B, S, D)})
    if not backward:
        return rows
    got = self_attention_bwd(qb, kb, vb, out32, dob, lse, rate, seed)
    want = attention_bwd_reference(qb, kb, vb, dob, seed, rate)
    _assert_all_close(got, want, K2_BF16_BWD_TOL, "K2 bf16 bwd")
    _expect(all(g.dtype == bf for g in got), "K2 bf16 bwd: not bf16 gradients")
    _expect(all(torch.equal(a, b) for a, b in zip(self_attention_bwd(qb, kb, vb, out32, dob, lse, rate, seed), got)),
            "K2 bf16 bwd: two launches differ")
    qh, kh, vh = (t[:, None].clone().requires_grad_(True) for t in (qb, kb, vb))
    lib_out = F.scaled_dot_product_attention(qh, kh, vh, dropout_p=rate)
    rows.append({"name": "self_attention_bf16_bwd", **k2b, "replaces": "neuradar_tpu/ops/attention.py:196",
                 "path": path, "shape": [B, S, D], "dtype": "bfloat16", "dropout": rate,
                 "max_abs_err": max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)),
                 **_times(lambda: self_attention_bwd(qb, kb, vb, out32, dob, lse, rate, seed),
                          lambda: attention_bwd_reference(qb, kb, vb, dob, seed, rate),
                          lambda: torch.autograd.grad(lib_out, (qh, kh, vh), dob[:, None], retain_graph=True)),
                 # q, k, v, dO in bf16, out32 and lse in float32 read; dq, dk, dv in bf16 written
                 **_k2_bf16_bound(2 * 4 * B * S * D + 4 * (B * S * D + B * S) + 2 * 3 * B * S * D,
                                  10 * B * S * S * D, K2_BF16_BWD_PASSES, B, S, D)})
    return rows


def check_kernels(device: torch.device) -> list:
    """Each kernel against its plain version at the shapes of the render and train paths."""
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    k1 = {"route": "cuda", "source": "neuradar_tpu_torch/csrc/composite_sky.cu"}
    k2 = {"route": "cuda", "source": "neuradar_tpu_torch/csrc/attention.cu"}

    # K1 forward at one render chunk (32 NeRF samples + the sky sample, nff_out_dim 32) and at one
    # train chunk of the 113,840-ray step, held against the plain version in float64: the kernel and
    # the float32 plain version round each ray's 33-term sums in their own orders, and where the
    # weighted features cancel their two errors together can pass K1_TOL's atol
    S, C = 33, 32
    for path, R in (("render", 32768), ("render_cli", 32768), ("train", 113840 // NFF_CHUNKS)):
        alpha = torch.rand((R, S), generator=gen, device=device)
        feats = torch.randn((R, S, C), generator=gen, device=device)
        got = [t.double() for t in composite_sky_fwd(alpha, feats)]
        want = composite_sky_reference(alpha.double(), feats.double())
        _assert_all_close(got, want, K1_TOL, f"K1 fwd {path}")
        rows.append({"name": "composite_sky_fwd", **k1, "replaces": "neuradar_tpu/ops/volumetric.py:100",
                     "path": path, "shape": [R, S, C], "max_abs_err": _max_err(got, want),
                     **_times(lambda: composite_sky_fwd(alpha, feats), lambda: composite_sky_reference(alpha, feats)),
                     **_bound(4 * (R * S * (C + 2) + R * (C + 1)), R * S * (2 * C + 8))})

    # K1 backward at the train chunk, on the train chunk's alpha and feats; a second launch must agree
    # bit for bit (no atomics)
    cots = (torch.randn((R, S), generator=gen, device=device), torch.randn((R, C), generator=gen, device=device),
            torch.randn((R, 1), generator=gen, device=device))
    got, want = composite_sky_bwd(alpha, feats, *cots), composite_sky_bwd_reference(alpha, feats, *cots)
    _assert_all_close(got, want, K1_BWD_TOL, "K1 bwd")
    _expect(all(torch.equal(a, b) for a, b in zip(composite_sky_bwd(alpha, feats, *cots), got)),
            "K1 bwd: two launches differ")
    rows.append({"name": "composite_sky_bwd", **k1, "replaces": "neuradar_tpu/ops/volumetric.py:125",
                 "path": "train", "shape": [R, S, C], "design": composite_sky_bwd_path(feats, cots[1]),
                 "max_abs_err": _max_err(got, want),
                 # the plain version syncs once a call: torch's cumprod backward checks its input for zeros
                 **_times(lambda: composite_sky_bwd(alpha, feats, *cots),
                          lambda: composite_sky_bwd_reference(alpha, feats, *cots), plain_syncs=True),
                 **_bound(4 * (2 * R * S * C + 3 * R * S + R * C + R), R * S * (3 * C + 12))})

    # K2 forward at a radar decode group of the render path, dropout 0 (the 4 scans it renders, in
    # the model's decode groups: 1 scan of the ZOD FoV each, d_model 48), and of the render commands'
    # path, which renders one scan at a time
    B, S, D = _group_scans(ADNeuRadarPipelineConfig().model, len(RENDER_RADAR_SCANS)), ZOD_SCAN_RAYS, 48
    for path in ("render", "render_cli"):
        q, k, v = (torch.randn((B, S, D), generator=gen, device=device) for _ in range(3))
        got, want = self_attention_fwd(q, k, v), attention_reference(q, k, v)
        torch.testing.assert_close(got, want, **K2_TOL, msg=lambda m: f"K2 fwd: {m}")
        rows.append({"name": "self_attention_fwd", **k2, "replaces": "neuradar_tpu/ops/attention.py:176",
                     "path": path, "shape": [B, S, D], "dropout": 0.0, "max_abs_err": float((got - want).abs().max()),
                     **_times(lambda: self_attention_fwd(q, k, v), lambda: attention_reference(q, k, v),
                              lambda: F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None])),
                     **_k2_bound(4 * 4 * B * S * D, 4 * B * S * S * D)})

    # K2 forward with dropout and backward at a radar decode group of the train path (the preset decodes
    # its 16 scans in 4 groups of 4), rate 0.1, one seed; a second launch of each must agree bit for bit
    preset = method_configs["neuradar-synthetic"]().pipeline
    B, rate, seed = _group_scans(preset.model, preset.datamanager.num_radar_scans), 0.1, 1234
    q, k, v, dout = (torch.randn((B, S, D), generator=gen, device=device) for _ in range(4))
    out, lse = self_attention_fwd(q, k, v, rate, seed, return_lse=True)
    want = attention_reference(q, k, v, seed, rate)
    torch.testing.assert_close(out, want, **K2_TOL, msg=lambda m: f"K2 fwd dropout: {m}")
    again = self_attention_fwd(q, k, v, rate, seed, return_lse=True)
    _expect(torch.equal(again[0], out) and torch.equal(again[1], lse), "K2 fwd: two launches differ")
    # SDPA's backward alone, through autograd, on graphs built with and without dropout
    qh, kh, vh = (t[:, None].clone().requires_grad_(True) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qh, kh, vh, dropout_p=rate)
    lib_out_nodrop = F.scaled_dot_product_attention(qh, kh, vh)
    rows.append({"name": "self_attention_fwd", **k2, "replaces": "neuradar_tpu/ops/attention.py:176",
                 "path": "train", "shape": [B, S, D], "dropout": rate, "max_abs_err": float((out - want).abs().max()),
                 **_times(lambda: self_attention_fwd(q, k, v, rate, seed, return_lse=True),
                          lambda: attention_reference(q, k, v, seed, rate),
                          lambda: F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None], dropout_p=rate)),
                 **_k2_bound(4 * (4 * B * S * D + B * S), 4 * B * S * S * D)})
    got = self_attention_bwd(q, k, v, out, dout, lse, rate, seed)
    want = attention_bwd_reference(q, k, v, dout, seed, rate)
    _assert_all_close(got, want, K2_BWD_TOL, "K2 bwd")
    _expect(all(torch.equal(a, b) for a, b in zip(self_attention_bwd(q, k, v, out, dout, lse, rate, seed), got)),
            "K2 bwd: two launches differ")
    rows.append({"name": "self_attention_bwd", **k2, "replaces": "neuradar_tpu/ops/attention.py:196",
                 "path": "train", "shape": [B, S, D], "dropout": rate, "max_abs_err": _max_err(got, want),
                 **_times(lambda: self_attention_bwd(q, k, v, out, dout, lse, rate, seed),
                          lambda: attention_bwd_reference(q, k, v, dout, seed, rate),
                          lambda: torch.autograd.grad(lib_out, (qh, kh, vh), dout[:, None], retain_graph=True)),
                 "library_no_dropout_ms": device_ms(lambda: torch.autograd.grad(
                     lib_out_nodrop, (qh, kh, vh), dout[:, None], retain_graph=True)),
                 **_k2_bound(4 * (8 * B * S * D + B * S), 10 * B * S * S * D)})

    # the bf16 train path, and the set decoder's train path, which runs its encoder at bf16 in the same
    # radar decode groups and its per-ray core in as many chunks
    bench = bench_pipeline_config("full", chunks=BF16_CHUNKS)
    rows += _bf16_path_rows(gen, device, "train_bf16", bench.model, bench.datamanager.num_radar_scans, rate, seed)
    set_cfg = _set_config().pipeline
    rows += _bf16_path_rows(gen, device, "train_set", set_cfg.model, set_cfg.datamanager.num_radar_scans, rate, seed)
    # the paper's presets: neuradar at its full batch (bf16, 8 chunks, radar in 4 groups) and neurad
    # (no radar: 57,344 rays in 8 chunks, K1 alone)
    for name in PRESETS:
        pcfg = get_method(name).pipeline
        dm = pcfg.datamanager
        rays = dm.num_rgb_patches * dm.patch_size**2 + dm.num_lidar_rays + dm.num_radar_scans * ZOD_SCAN_RAYS
        rows += _bf16_path_rows(gen, device, f"train_{name}", pcfg.model, dm.num_radar_scans, rate, seed, rays)
    # neuradar's eval frame (render chunks of eval_num_rays_per_chunk rays, each in the preset's nff
    # chunks) and its radar scan (one scan of the ZOD FoV: its rays in one chunk, one decode group),
    # without dropout
    pm = get_method("neuradar").pipeline.model
    rows += _bf16_path_rows(gen, device, "render_neuradar", pm, 0, 0.0, seed, pm.eval_num_rays_per_chunk,
                            backward=False)
    rows += _bf16_path_rows(gen, device, "render_radar_neuradar", pm, 1, 0.0, seed, ZOD_SCAN_RAYS, backward=False)
    # VoD's preset: its train batch (127,744 rays, 8 chunks of 15,968; K2 at bf16 on [4, 4400, 48] with
    # dropout), its eval frame (render chunks of 32,768 rays, each in 8 nff chunks) and the FID evals'
    # renders (the same chunks), and one radar scan: 4,400 rays divide by the 8 nff chunks, so K1 runs on
    # chunks of 550 rays there; K2 at bf16 on [1, 4400, 48] without dropout. One K1 forward row also at
    # a whole scan's [4400, 33, 32], which no path runs ("standalone")
    vm = get_method(VOD_PRESET).pipeline.model
    rows += _bf16_path_rows(gen, device, f"train_{VOD_PRESET}", vm, 16, rate, seed, VOD_STEP_RAYS,
                            rays_per_scan=VOD_SCAN_RAYS)
    for path in (f"render_{VOD_PRESET}", f"fid_{VOD_PRESET}"):
        rows += _bf16_path_rows(gen, device, path, vm, 0, 0.0, seed, vm.eval_num_rays_per_chunk, backward=False)
    rows += _bf16_path_rows(gen, device, f"render_radar_{VOD_PRESET}", vm, 1, 0.0, seed, VOD_SCAN_RAYS,
                            backward=False, rays_per_scan=VOD_SCAN_RAYS)
    with trace.recording():
        rows += _bf16_path_rows(gen, device, "standalone", replace(vm, nff_chunks=1), 0, 0.0, seed, VOD_SCAN_RAYS,
                                backward=False)
        rows[-1]["launches"] = _launches(trace.snapshot())["composite_sky_fwd"]
    # the renders of the bf16 program's and the set model's phases: the bench frame (96 x 156 at the x3
    # upsample, one render chunk in 8 nff chunks); one radar scan of the set model (its 3,531 rays in one
    # chunk, one decode group) and its eval radar metrics' batch of the eval scans (one chunk; a decode
    # group a scan)
    u = bench.model.rgb_upsample_factor
    rows += _bf16_path_rows(gen, device, "render_bf16", bench.model, 0, 0.0, seed, (96 // u) * (156 // u),
                            backward=False)
    rows += _bf16_path_rows(gen, device, "render_radar_set", set_cfg.model, 1, 0.0, seed, ZOD_SCAN_RAYS,
                            backward=False)
    n_eval = len(linspaced_split(SyntheticDataParserConfig().num_frames).eval)
    rows += _bf16_path_rows(gen, device, "eval_radar_set", set_cfg.model, n_eval, 0.0, seed, n_eval * ZOD_SCAN_RAYS,
                            backward=False)

    # K3 at a render chunk's shape with sample midpoints, against its plain version in float64 (as K1)
    R, S, C = 32768, 33, 32
    alpha = torch.rand((R, S), generator=gen, device=device)
    feats = torch.randn((R, S, C), generator=gen, device=device)
    steps = torch.cumsum(torch.rand((R, S), generator=gen, device=device), dim=-1)
    with trace.recording():
        got = [t.double() for t in fused_composite(alpha, feats, steps)]
        want = composite_reference(alpha.double(), feats.double(), steps.double())
        _assert_all_close(got, want, K1_TOL, "K3")
        rows.append({"name": "fused_composite", **k1, "replaces": "neuradar_tpu/ops/volumetric.py:199",
                     "path": "standalone", "shape": [R, S, C], "max_abs_err": _max_err(got, want),
                     **_times(lambda: fused_composite(alpha, feats, steps),
                              lambda: composite_reference(alpha, feats, steps)),
                     **_bound(4 * (R * S * (C + 3) + R * (C + 2)), R * S * (2 * C + 6))})
        rows[-1]["launches"] = _launches(trace.snapshot())["composite_fwd"]

    # P1 at the probe's shape, at one static hash grid's table (8 x 2^22 rows of 4 features, 512 MiB)
    # and at a proposal grid's (6 x 2^20 rows of 1 feature, the scalar path), each with 2^22 random
    # indices; exact. A random row of 16 bytes costs a whole 32-byte sector to read, so the row also
    # gives the bound by sectors beside the bound by the bytes the function needs. "design" names the
    # kernel's path.
    p1 = {"route": "cuda", "source": "neuradar_tpu_torch/csrc/gather.cu"}
    for T, n_feat, N in ((4096, 8, 1024), (8 * 2**22, 4, 2**22), (6 * 2**20, 1, 2**22)):
        table = torch.randn((T, n_feat), generator=gen, device=device)
        idx = torch.randint(0, T, (N,), generator=gen, device=device, dtype=torch.int32)
        with trace.recording():
            got, want = gather.row_gather(table, idx), gather.row_gather_reference(table, idx)
            gather.check_indices(device)
            _expect(torch.equal(got, want), f"P1 [{T}, {n_feat}] x {N}: the gather differs from its plain version")
            rows.append({"name": "row_gather", **p1, "replaces": "tools/probe_mosaic_gather.py:34",
                         "path": "standalone", "shape": [T, n_feat, N], "design": gather.row_gather_path(table),
                         "max_abs_err": float((got - want).abs().max()),
                         **_times(lambda: gather.row_gather(table, idx),
                                  lambda: gather.row_gather_reference(table, idx),
                                  lambda: torch.index_select(table, 0, idx)),
                         "sector_bound_ms": bounds_ms(n_feat, N)["sector_bound_ms"],
                         **_bound(N * (2 * n_feat * 4 + 4), 0)})
            gather.check_indices(device)
            rows[-1]["launches"] = _launches(trace.snapshot())["row_gather"]
        del table, idx, got, want
    return rows


def _finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x).all())


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def render_full_width(device: torch.device) -> None:
    """The main path: full-width neuradar-synthetic, seeded random weights."""
    out = SyntheticDataParser(SyntheticDataParserConfig(
        num_frames=4, image_height=720, image_width=1296, lidar_points_per_scan=16384, seed=0,
    )).get_dataparser_outputs()
    pipe = ADNeuRadarPipeline(ADNeuRadarPipelineConfig(), out, device, seed=0)
    n_params = sum(p.numel() for p in pipe.model.parameters())
    phase("render_setup", n_params=n_params, rays_per_radar_scan=pipe.tables.radars.rays_per_scan)

    # the 4-frame scene's eval split is frame 0 alone; frame 3 is the second render
    for cam_idx in (0, 3):
        rend = pipe.render_camera(cam_idx)
        shapes = {k: list(v.shape) for k, v in rend.items()}
        finite = all(_finite(v) for v in rend.values())
        phase("render_camera", cam_idx=cam_idx, shapes=shapes, finite=finite, rays=int(rend["depth"].numel()))
        _expect(finite and shapes["rgb"] == [720, 1296, 3] and shapes["depth"] == [240, 432],
                f"render_camera {cam_idx}: {shapes}, finite={finite}")

    rend = pipe.render_lidar(0, max_points=16384)
    shapes = {k: list(rend[k].shape) for k in ("depth", "intensity", "ray_drop_prob")}
    finite = all(_finite(rend[k]) for k in shapes)
    phase("render_lidar", shapes=shapes, finite=finite, num_valid=rend["num_valid"])
    _expect(finite and all(s == [16384, 1] for s in shapes.values()), f"render_lidar: {shapes}, finite={finite}")

    rend = pipe.render_radar(list(RENDER_RADAR_SCANS))
    ro = rend["radar_output"]
    finite = _finite(ro)
    phase("render_radar", shape=list(ro.shape), finite=finite)
    _expect(finite and list(ro.shape) == [len(RENDER_RADAR_SCANS), pipe.tables.radars.rays_per_scan, 7],
            f"render_radar: {list(ro.shape)}, finite={finite}")
    del pipe
    torch.cuda.empty_cache()


def _param_groups(trainer: Trainer) -> dict:
    groups = {}
    for name, p in trainer.model.named_parameters():
        groups.setdefault(trainer.optimizer.labels[name], []).append(p)
    return groups


def train_full_width(device: torch.device) -> None:
    """This slice's path: the neuradar-synthetic trainer at full width and batch, seeded."""
    torch.cuda.empty_cache()
    cfg = method_configs["neuradar-synthetic"]()
    cfg.pipeline.model.nff_chunks = NFF_CHUNKS
    trainer = Trainer(cfg, cfg.dataparser.setup().get_dataparser_outputs(), device)
    trainer.setup()
    layout = trainer.pipeline.layout
    phase("train_setup", seed=cfg.seed,
          n_params=sum(p.numel() for p in trainer.model.parameters()), rays_per_step=layout.total,
          camera_rays=layout.num_cam, lidar_rays=layout.num_lidar, radar_scans=layout.num_radar_scans,
          rays_per_radar_scan=layout.rays_per_scan, nff_chunks=NFF_CHUNKS)
    groups = _param_groups(trainer)
    before = {g: [p.detach().clone() for p in ps] for g, ps in groups.items()}
    for step in range(TRAIN_STEPS):
        losses, metrics = trainer.train_step()
        values = {k: float(v) for k, v in losses.items()}
        finite = all(torch.isfinite(torch.tensor(v)) for v in values.values())
        phase("train_step", step=step, finite=finite, losses=values, metrics={k: float(v) for k, v in metrics.items()})
        _expect(finite, f"train step {step}: a loss term is not finite: {values}")
    losses, metrics = trainer.eval_loss()
    values = {k: float(v) for k, v in losses.items()}
    finite = all(torch.isfinite(torch.tensor(v)) for v in values.values())
    phase("eval_loss", finite=finite, losses=values, metrics={k: float(v) for k, v in metrics.items()})
    _expect(finite, f"eval loss not finite: {values}")
    changed = {g: any(not torch.equal(p, q) for p, q in zip(groups[g], before[g])) for g in groups}
    phase("train_params_changed", groups=changed)
    _expect(all(changed.values()), f"a parameter group did not change: {changed}")
    trainer.shutdown()
    del trainer, before, groups
    torch.cuda.empty_cache()


def train_bf16(device: torch.device) -> dict:
    """This slice's path: the JAX package's benchmark program in bf16, trained by a Trainer at the
    full batch on the bench scene (3 steps), then an eval loss and a camera render. The kernels'
    launches are counted apart for the steps with the eval loss (train_bf16) and the render
    (render_bf16)."""
    torch.cuda.empty_cache()
    cfg = TrainerConfig(pipeline=bench_pipeline_config("full", chunks=BF16_CHUNKS),
                        optimizers=default_optimizer_groups(2001),
                        steps_per_eval_batch=0, steps_per_eval_image=0, steps_per_eval_all_images=0,
                        steps_per_eval_all_radars=0, steps_per_save=0, save_final_checkpoint=False,
                        output_dir="chiprun_out/train_bf16")
    trainer = Trainer(cfg, bench_scene_outputs(), device)
    trainer.setup()
    layout = trainer.pipeline.layout
    m = cfg.pipeline.model
    phase("train_bf16_setup", seed=cfg.seed, compute_dtype=m.compute_dtype, hoist_table_cast=m.hoist_table_cast,
          nff_chunks=m.nff_chunks, radar_decode_chunks=m.radar_decode_chunks, vgg_mult=m.loss.vgg_mult,
          rays_per_step=layout.total, camera_rays=layout.num_cam, lidar_rays=layout.num_lidar,
          radar_scans=layout.num_radar_scans, rays_per_radar_scan=layout.rays_per_scan)
    _expect(layout.total == 113840 and m.compute_dtype == "bfloat16",
            f"bf16 program: {layout.total} rays, {m.compute_dtype}")
    with trace.recording():
        for step in range(TRAIN_STEPS):
            losses, metrics = trainer.train_step()
            values = {k: float(v) for k, v in losses.items()}
            finite = all(math.isfinite(v) for v in values.values())
            phase("train_bf16_step", step=step, finite=finite, losses=values,
                  metrics={k: float(v) for k, v in metrics.items()})
            _expect(finite, f"bf16 train step {step}: a loss term is not finite: {values}")
        losses, metrics = trainer.eval_loss()
        values = {k: float(v) for k, v in losses.items()}
        _expect(all(math.isfinite(v) for v in values.values()), f"bf16 eval loss not finite: {values}")
        launches = {"train_bf16": _launches(trace.snapshot())}
    with trace.recording():
        rend = trainer.pipeline.render_camera(0)
        launches["render_bf16"] = _launches(trace.snapshot())
    shapes = {k: list(v.shape) for k, v in rend.items()}
    _expect(all(_finite(v) for v in rend.values()) and shapes["rgb"] == [96, 156, 3],
            f"bf16 render_camera: {shapes}")
    trainer.shutdown()
    del trainer
    torch.cuda.empty_cache()
    return {"launches": launches, "eval_loss": {"losses": values}, "render_camera": {"shapes": shapes}}


def _set_config() -> TrainerConfig:
    """neuradar-synthetic with the set radar decoder's settings, parsed as scripts/train.py parses the
    train command's dotted overrides."""
    cfg = get_method("neuradar-synthetic")
    parse_overrides(cfg, SET_ARGV)
    return cfg


def _finite_dict(d: dict) -> bool:
    return all(math.isfinite(float(v)) for v in d.values())


def train_set(device: torch.device) -> dict:
    """This slice's path: the set radar decoder's model trained at the preset's full batch, 3 steps
    with the auction and 1 with the host's Hungarian, then an eval loss, one scan's render_radar and
    the eval radar metrics. The kernels' launches are counted apart for the steps with the eval loss
    (train_set), the scan's render (render_radar_set) and the metrics' render (eval_radar_set)."""
    torch.cuda.empty_cache()
    cfg = _set_config()
    cfg.steps_per_eval_batch = cfg.steps_per_eval_image = cfg.steps_per_eval_all_images = 0
    cfg.steps_per_eval_all_radars = cfg.steps_per_save = 0
    cfg.save_final_checkpoint = False
    cfg.output_dir = "chiprun_out/train_set"
    trainer = Trainer(cfg, cfg.dataparser.setup().get_dataparser_outputs(), device)
    trainer.setup()
    layout = trainer.pipeline.layout
    m = cfg.pipeline.model
    phase("train_set_setup", seed=cfg.seed, overrides=SET_ARGV,
          rays_per_step=layout.total, camera_rays=layout.num_cam, lidar_rays=layout.num_lidar,
          radar_scans=layout.num_radar_scans, rays_per_radar_scan=layout.rays_per_scan,
          radar_decode_groups=radar_decode_groups(layout.num_radar_scans, m.radar_decode_chunks))
    _expect(layout.total == FULL_BATCH_RAYS and layout.num_radar_scans == 16 and layout.rays_per_scan == 3531
            and m.radar_decoder_type == "set" and m.num_radar_queries == 300 and m.compute_dtype == "bfloat16"
            and m.nff_chunks == 8 and m.loss.radar_set_loss == "detr" and m.loss.vgg_mult == 0.05,
            f"set program: {layout}, {m}")
    groups = _param_groups(trainer)
    before = {g: [p.detach().clone() for p in ps] for g, ps in groups.items()}
    query_embed = trainer.model.radar_decoder.query_embed
    query_before = query_embed.detach().clone()
    assignments = ["auction"] * SET_AUCTION_STEPS + ["hungarian"]
    with trace.recording():
        for step, assignment in enumerate(assignments):
            m.loss.radar_assignment = assignment
            losses, metrics = trainer.train_step()
            values = {k: float(v) for k, v in losses.items()}
            phase("train_set_step", step=step, assignment=assignment, finite=_finite_dict(values), losses=values,
                  metrics={k: float(v) for k, v in metrics.items()})
            _expect(_finite_dict(values) and "radar_aux_loss" in values, f"set train step {step}: {values}")
        losses, metrics = trainer.eval_loss()
        eval_values = {k: float(v) for k, v in losses.items()}
        _expect(_finite_dict(eval_values), f"set eval loss not finite: {eval_values}")
        snap = trace.snapshot()
    launches = {"train_set": _launches(snap)}
    # the Hungarian step: the main loss and the one intermediate layer's, one host round trip each
    calls = [snap.count("hungarian_calls", [unit]) for unit in snap.units("train/step")]
    _expect(calls == [0] * SET_AUCTION_STEPS + [2], f"Hungarian calls per step: {calls}")
    scan = int(trainer.pipeline.datamanager.eval_radar_indices()[0])
    with trace.recording():
        rend = trainer.pipeline.render_radar(scan)
        launches["render_radar_set"] = _launches(trace.snapshot())
    ro = rend["radar_output"]
    _expect(list(ro.shape) == [300, 7] and _finite(ro), f"set render_radar: {list(ro.shape)}")
    with trace.recording():
        radar_metrics = trainer.pipeline.get_average_eval_radar_metrics()
        launches["eval_radar_set"] = _launches(trace.snapshot())
    _expect(_finite_dict(radar_metrics), f"set eval radar metrics: {radar_metrics}")
    changed = {g: any(not torch.equal(p, q) for p, q in zip(groups[g], before[g])) for g in groups}
    changed["query_embed"] = not torch.equal(query_embed.detach(), query_before)
    phase("train_set_params_changed", groups=changed)
    # the VGG loss's filters are frozen; every other group trains
    _expect(not changed.pop("frozen") and all(changed.values()), f"a parameter group did not change: {changed}")
    trainer.shutdown()
    del trainer, before, groups
    torch.cuda.empty_cache()
    return {"hungarian_calls": calls, "launches": launches, "eval_loss": {"losses": eval_values},
            "render_radar": {"shape": list(ro.shape)}, "eval_radar_metrics": radar_metrics}


def _index_add_scatter(grads, idxs, table_shape) -> torch.Tensor:
    """The library formulation of the scatter: every corner's rows added at once into a float32 table
    by torch's index_add_ (atomics, no sort), then one cast to the gradients' dtype."""
    acc = torch.zeros(table_shape, dtype=torch.float32, device=grads[0].device)
    acc.index_add_(0, torch.cat([i.reshape(-1) for i in idxs]),
                   torch.cat([g.reshape(-1, table_shape[1]) for g in grads]).float())
    return acc.to(grads[0].dtype)


K4_SOURCE = {"route": "cuda", "source": "neuradar_tpu_torch/csrc/hash_encode.cu",
             "replaces": "none (XLA in the JAX package: neuradar_tpu/field_components/encodings.py:192-248)"}
SECTOR_BYTES = 32  # the card's smallest read from device memory


def _k4_capture(fn) -> tuple:
    """Run ``fn`` with the encode's op wrapped and the port's counters recording. Per grid (d, L, T, F):
    the first encode's inputs, and the first encode with a gradient's inputs with its output's gradient
    (a hook; a recomputed chunk's gradient reaches the first forward's output). Returns both and the
    counts of encodes (``hash_encode`` spans), of the forward kernel's launches and of host syncs."""
    fwd, bwd = {}, {}
    op = hash_encode_op.hash_encode

    def wrapped(positions, table, scalings, T, L, F):
        out = op(positions, table, scalings, T, L, F)
        key = (positions.shape[1], L, T, F)

        def inputs():
            return {"positions": positions.detach().clone(), "table": table.detach().clone(),
                    "scalings": tuple(scalings), "T": T, "L": L, "F": F}

        if key not in fwd:
            fwd[key] = inputs()
        if out.requires_grad and key not in bwd:
            cap = bwd[key] = {**inputs(), "pos_grad": positions.requires_grad, "table_grad": table.requires_grad}
            out.register_hook(lambda g: cap.setdefault("grad_out", g.detach().clone()))
        return out

    hash_encode_op.hash_encode = wrapped
    try:
        with trace.recording():
            fn()
            snap = trace.snapshot()
    finally:
        hash_encode_op.hash_encode = op
    return fwd, bwd, {"encodes": sum(s.name == "hash_encode" for s in snap.spans),
                      "hash_encode_fwd": snap.total("launches/hash_encode_fwd"), "host_syncs": snap.total("host_syncs")}


def _k4_grid(cap) -> str:
    return f"{cap['L']}x{cap['T']}x{cap['F']}, d {cap['positions'].shape[1]}"


def _k4_lookup_bytes(pos: torch.Tensor, table: torch.Tensor, scal, T: int, L: int, F: int) -> int:
    """The bytes the lookups of these positions need from device memory: the distinct 32-byte sectors
    that each level's corner rows touch (at most the level's table; a sector read twice, or served from
    the L2, counts once)."""
    rows = encodings.corner_rows(pos.to(table.dtype), scal, T, L)
    sectors = torch.stack([i for i, _ in rows]) * (F * table.element_size()) // SECTOR_BYTES
    del rows
    return SECTOR_BYTES * int(torch.unique(sectors).numel())


def _k4_fwd_row(cap: dict, path: str) -> dict:
    """K4's forward on one encode's own inputs: bit-equal to the plain path, its time against its bytes
    bound (positions read once, output written once, the lookups' distinct sectors) and the plain
    path's."""
    pos, table, scal, T, L, F = (cap[k] for k in ("positions", "table", "scalings", "T", "L", "F"))
    (N, d), R = pos.shape, table.dtype

    def plain():
        return encodings.hash_encode(pos.to(R), table, scal, T, L, F).to(pos.dtype)

    with torch.no_grad():
        equal = torch.equal(hash_encode_fwd(pos, table, scal, T, L, F), plain())
        _expect(equal, f"K4 fwd on {path}'s encode of {_k4_grid(cap)}: not the plain path's bits")
        row = {"name": "hash_encode_fwd", **K4_SOURCE, "path": path, "grid": _k4_grid(cap), "shape": [N, d, L, T, F],
               "dtype": str(R).removeprefix("torch."), "bit_equal": equal, "launches_per_encode": 1,
               **_times(lambda: hash_encode_fwd(pos, table, scal, T, L, F), plain, plain_syncs=True),
               **_bound(N * d * pos.element_size() + N * L * F * pos.element_size()
                        + _k4_lookup_bytes(pos, table, scal, T, L, F), N * L * 2**d * (d - 1 + 2 * F))}
    return row


def _k4_bwd_row(cap: dict, path: str) -> dict:
    """K4's backward on one encode's own inputs and output gradient: the table's gradient held to the
    float64 sum of the plain path's corner gradients (``float64_sum``), the positions' no further (L2)
    from their float64 evaluation (``encodings.positions_grad_float64``) than plain autograd's, the share
    of the corner gradients (rows of F values) that are exact zeros (the kernel skips them), its time
    against its bytes bound (positions and the output's gradient read once, the gradients written once;
    the lookups' distinct sectors where the positions need a gradient), the plain path's backward and the
    library call's (``_index_add_scatter`` of the corner gradients: the table's alone)."""
    pos, table, scal, T, L, F = (cap[k] for k in ("positions", "table", "scalings", "T", "L", "F"))
    grad_out, pos_grad, table_grad = cap["grad_out"].contiguous(), cap["pos_grad"], cap["table_grad"]
    (N, d), R = pos.shape, table.dtype

    def kernel():
        return hash_encode_bwd(grad_out, pos, table, scal, T, L, F, pos_grad, table_grad)

    gp, gt = kernel()
    rows = encodings.corner_rows(pos.to(R), scal, T, L)
    g = grad_out.to(R).reshape(N, L, F)
    grads, idxs = [g * w[..., None] for _, w in rows], [i for i, _ in rows]
    del rows
    pp = pos.clone().requires_grad_(pos_grad)
    tp = table.clone().requires_grad_(table_grad)
    out = encodings.hash_encode(pp.to(R), tp, scal, T, L, F).to(pos.dtype)
    wrt = [t for t, need in ((pp, pos_grad), (tp, table_grad)) if need]
    plain_grads = torch.autograd.grad(out, wrt, grad_out, retain_graph=True)
    row = {"name": "hash_encode_bwd", **K4_SOURCE, "path": path, "grid": _k4_grid(cap), "shape": [N, d, L, T, F],
           "dtype": str(R).removeprefix("torch."), "pos_grad": pos_grad, "table_grad": table_grad,
           "zero_share": float(sum((c == 0).all(dim=-1).sum() for c in grads)) / (2**d * N * L),
           "launches_per_encode": math.ceil(L / levels_per_launch(T, F, L, R)) if table_grad else 1}
    if table_grad:
        exact, bound = float64_sum(grads, idxs, (L * T, F))
        err = (gt.view(L * T, F).double() - exact).abs()
        _expect(bool((err <= bound).all()), f"K4 bwd on {path}'s encode of {_k4_grid(cap)}: off the float64 sum")
        row["max_abs_err"] = float(err.max())
        del exact, bound, err
    if pos_grad:
        ref = encodings.positions_grad_float64(pos.to(R), table, scal, T, L, grad_out)
        err, err_plain = float((gp.double() - ref).norm()), float((plain_grads[0].double() - ref).norm())
        row.update(pos_grad_ref_norm=float(ref.norm()), pos_grad_err=err, pos_grad_err_plain=err_plain)
        _expect(err <= err_plain, f"K4 bwd on {path}'s encode of {_k4_grid(cap)}: the positions' gradient is "
                                  f"further from float64 ({err}) than plain autograd's ({err_plain})")
        del ref
    pos_bytes, e = pos.element_size(), table.element_size()
    nbytes = N * d * pos_bytes + N * L * F * pos_bytes + (L * T * F * e if table_grad else 0)
    if pos_grad:
        nbytes += N * d * pos_bytes + _k4_lookup_bytes(pos, table, scal, T, L, F)
    row.update(**_times(kernel, lambda: torch.autograd.grad(out, wrt, grad_out, retain_graph=True),
                        (lambda: _index_add_scatter(grads, idxs, (L * T, F))) if table_grad else None,
                        plain_syncs=True),
               **_bound(nbytes, N * L * 2**d * (2 * F + (d * d + F if pos_grad else 0))))
    return row


def _k4_rows(trainer: Trainer, name: str) -> list:
    """K4's rows on the preset's own encodes, one a grid and path: one more train step (path
    train_<name>: forward and backward rows), and with radar an eval frame (render_<name>) and a radar
    scan (render_radar_<name>), forward rows. Every encode of each must take the kernel (one
    ``hash_encode_fwd`` launch an encode). With the camera optimizer on, the static grid's positions
    need a gradient on the train path, and its row must check it on a gradient that is not all zeros."""
    pipe = trainer.pipeline
    runs = [(f"train_{name}", trainer.train_step)]
    if pipe.layout.num_radar_scans > 0:
        cam_idx = int(pipe.datamanager.eval_camera_indices()[0])
        scan = int(pipe.datamanager.eval_radar_indices()[0])
        runs += [(f"render_{name}", lambda: pipe.render_camera(cam_idx)),
                 (f"render_radar_{name}", lambda: pipe.render_radar(scan))]
    rows = []
    for path, fn in runs:
        fwd, bwd, counts = _k4_capture(fn)
        phase("k4_encodes", path=path, **counts)
        _expect(counts["hash_encode_fwd"] == counts["encodes"] > 0, f"{path}: an encode launched no kernel: {counts}")
        rows += [_k4_fwd_row(cap, path) for cap in fwd.values()]
        rows += [_k4_bwd_row(cap, path) for cap in bwd.values()]
        del fwd, bwd
        torch.cuda.empty_cache()
    if trainer.config.pipeline.model.camera_optimizer.mode != "off":
        static = [r for r in rows if r["name"] == "hash_encode_bwd" and r["shape"][1] == 3 and r["pos_grad"]]
        _expect(any(r["pos_grad_ref_norm"] > 0 for r in static),
                f"{name}: no static grid's positions' gradient was checked on nonzero values: {static}")
    return rows


def train_preset(device: torch.device, name: str, scene, fid_frames: int = 0) -> dict:
    """The preset ``name`` of the port's registry, built as scripts/train.py builds it and trained by a
    Trainer on ``scene`` (explicit dataparser outputs) for PRESET_STEPS steps at its full width and
    batch; a preset with radar scans then takes an eval loss, renders an eval frame through
    render_camera and one radar scan. The loss terms; with the camera optimizer on, its group must have
    changed and its regularizer be finite. With ``fid_frames`` the trainer's pipeline then computes the
    shifted-view FIDs of that many eval frames (compute_fid_metrics): every family's value must be
    finite. The kernels' launches are counted apart for the train steps with the eval loss (path
    train_<name>, the train batch's shapes), the eval frame (render_<name>), the radar scan
    (render_radar_<name>) and the FIDs (fid_<name>)."""
    torch.cuda.empty_cache()
    cfg = get_method(name)
    cfg.steps_per_eval_batch = cfg.steps_per_eval_image = cfg.steps_per_eval_all_images = 0
    cfg.steps_per_eval_all_radars = cfg.steps_per_save = 0
    cfg.save_final_checkpoint = False
    cfg.output_dir = f"chiprun_out/train_{name}"
    trainer = Trainer(cfg, scene, device)
    trainer.setup()
    layout = trainer.pipeline.layout
    m = cfg.pipeline.model
    setup = {"rays_per_step": layout.total, "camera_rays": layout.num_cam, "lidar_rays": layout.num_lidar,
             "radar_scans": layout.num_radar_scans, "compute_dtype": m.compute_dtype, "nff_chunks": m.nff_chunks,
             "vgg_mult": m.loss.vgg_mult, "camera_optimizer": m.camera_optimizer.mode,
             "image_size": list(scene.image_size),
             "camera_types": torch.unique(trainer.pipeline.tables.cameras.camera_type).tolist()}
    phase(f"train_{name}_setup", **setup)
    groups = _param_groups(trainer)
    before = {g: [p.detach().clone() for p in ps] for g, ps in groups.items()}
    report = {"setup": setup}
    radar = layout.num_radar_scans > 0
    with trace.recording():
        for step in range(PRESET_STEPS):
            losses, metrics = trainer.train_step()
            values = {k: float(v) for k, v in losses.items()}
            phase(f"train_{name}_step", step=step, finite=_finite_dict(values), losses=values,
                  metrics={k: float(v) for k, v in metrics.items()})
            _expect(_finite_dict(values), f"{name} train step {step}: a loss term is not finite: {values}")
            _expect(("camera_opt_regularizer" in values) == (m.camera_optimizer.mode != "off"),
                    f"{name}: camera_opt_regularizer {sorted(values)}")
        if radar:
            losses, _ = trainer.eval_loss()
            eval_values = {k: float(v) for k, v in losses.items()}
            _expect(_finite_dict(eval_values), f"{name} eval loss not finite: {eval_values}")
            report["eval_loss"] = {"losses": eval_values}
        launches = {f"train_{name}": _launches(trace.snapshot())}
    # after the path's window: K4's extra step and renders are not the path's launches
    report["k4"] = _k4_rows(trainer, name)
    phase(f"train_{name}_k4", rows=report["k4"])
    changed = {g: any(not torch.equal(p, q) for p, q in zip(groups[g], before[g])) for g in groups}
    phase(f"train_{name}_params_changed", groups=changed)
    if m.camera_optimizer.mode != "off":
        _expect(changed.get("camera_opt", False), f"{name}: the camera_opt group did not change: {changed}")
    report["params_changed"] = changed
    pipe = trainer.pipeline
    u = m.rgb_upsample_factor
    H, W = scene.image_size
    if radar:
        cam_idx = int(pipe.datamanager.eval_camera_indices()[0])
        with trace.recording():
            rend = pipe.render_camera(cam_idx)
            launches[f"render_{name}"] = _launches(trace.snapshot())
        shapes = {k: list(v.shape) for k, v in rend.items()}
        _expect(all(_finite(v) for v in rend.values()) and shapes["rgb"] == [H // u * u, W // u * u, 3]
                and shapes["depth"] == [H // u, W // u], f"{name} render_camera: {shapes}")
        scan = int(pipe.datamanager.eval_radar_indices()[0])
        with trace.recording():
            rend_r = pipe.render_radar(scan)
            launches[f"render_radar_{name}"] = _launches(trace.snapshot())
        ro = rend_r["radar_output"]
        _expect(list(ro.shape) == [layout.rays_per_scan, 7] and _finite(ro),
                f"{name} render_radar: {list(ro.shape)}")
        report.update(render_camera={"cam_idx": cam_idx, "shapes": shapes, "rays": (H // u) * (W // u)},
                      render_radar={"shape": list(ro.shape)})
    if fid_frames:
        pipe.model.eval()
        with trace.recording():
            fid = pipe.compute_fid_metrics(max_frames=fid_frames)
            launches[f"fid_{name}"] = _launches(trace.snapshot())
        frames = min(fid_frames, len(pipe.datamanager.eval_camera_indices()))
        report["fid"] = {"frames": frames, "renders": frames * 8, "rays_per_render": (H // u) * (W // u),
                         "values": fid}
        phase(f"fid_{name}", **report["fid"], launches=launches[f"fid_{name}"])
        suffix = "" if has_pretrained_weights() else "_vggsurrogate"
        want = {f"{k}_fid{suffix}" for k in FID_FAMILIES}
        _expect(set(fid) == want and _finite_dict(fid), f"{name} FID: {fid}")
    report["launches"] = launches
    trainer.shutdown()
    del trainer, pipe, before, groups
    torch.cuda.empty_cache()
    return report



def _tiny_outputs():
    out = SyntheticDataParser(SyntheticDataParserConfig(
        num_frames=8, image_height=24, image_width=36, lidar_points_per_scan=256)).get_dataparser_outputs()
    out.radar_fov = dict(min_azimuth=-0.8, max_azimuth=0.8, min_elevation=-0.08, max_elevation=0.32,
                         azimuth_step=0.1, elevation_step=0.1)
    return out


def _tiny_pipeline(device, nff_chunks: int = 1, dtype: str = "float32", vgg: bool = False,
                   set_loss: str = "", preset: str = "") -> ADNeuRadarPipeline:
    """The tiny scene and model, radar in 2 groups; without the VGG loss 4-ray patches (12 pixels, too
    small for VGG-19's four pools), with it 8-ray patches (24 pixels). ``set_loss`` ("mb" or "detr")
    gives it the set radar decoder with TINY_SET_QUERIES queries and deep supervision. ``preset`` takes
    the model settings and radar scans (none for neurad) of that preset of the registry, and dresses
    the scene in ZOD's fisheye with its distortion and a rolling shutter."""
    out = _tiny_outputs()
    cfg = get_method(preset).pipeline if preset else ADNeuRadarPipelineConfig()
    cfg.datamanager = ADDataManagerConfig(num_rgb_patches=2, patch_size=8 if vgg else 4, num_lidar_rays=32,
                                          num_radar_scans=cfg.datamanager.num_radar_scans and 2, max_radar_gt=16)
    if preset:
        n = len(out.camera_to_worlds)
        out.camera_type = np.full(n, int(CameraType.FISHEYE))
        out.distortion_params = np.tile(np.array([ZOD_DIST], np.float32), (n, 1))
        out.camera_velocities = np.tile(np.array([[5.0, 0.0, 0.0]], np.float32), (n, 1))
        out.rolling_shutter_offsets = np.tile(np.array([[-0.02, 0.02]], np.float32), (n, 1))
    m = cfg.model
    m.compute_dtype = dtype
    m.radar_decode_chunks = 2
    m.loss.vgg_mult = 0.05 if vgg else 0.0
    m.field.grid.static.log2_hashmap_size = 12
    m.field.grid.actor.log2_hashmap_size = 10
    for pf in (m.sampling.proposal_field_1, m.sampling.proposal_field_2):
        pf.grid.static.log2_hashmap_size = 11
        pf.grid.actor.log2_hashmap_size = 9
    m.sampling.num_proposal_samples = (16, 8)
    m.sampling.num_nerf_samples = 6
    m.nff_chunks = nff_chunks
    if set_loss:
        m.radar_decoder_type = "set"
        m.loss.radar_set_loss = set_loss
        m.num_radar_queries = TINY_SET_QUERIES
        # the auction does not converge on the set decoder's near-equal costs at init, and the card's
        # last-bit cost differences then change its result (tests/test_torch_set_decoder.py)
        m.loss.radar_assignment = "hungarian"
    return ADNeuRadarPipeline(cfg, out, device, seed=0)


def check_tiny_agreement(device: torch.device) -> float:
    """Kernels on the card vs plain versions on the CPU, same weights, tiny scene."""
    gpu, cpu = _tiny_pipeline(device), _tiny_pipeline("cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    pairs = [
        (gpu.render_camera(1), cpu.render_camera(1), ("rgb", "depth", "accumulation")),
        (gpu.render_lidar(3, 300), cpu.render_lidar(3, 300), ("depth", "intensity", "ray_drop_prob")),
        (gpu.render_radar([0, 5]), cpu.render_radar([0, 5]), ("radar_output",)),
    ]
    worst = 0.0
    for g, c, keys in pairs:
        for key in keys:
            torch.testing.assert_close(g[key].cpu(), c[key], **TINY_TOL, msg=lambda m, key=key: f"{key}: {m}")
            worst = max(worst, float((g[key].cpu() - c[key]).abs().max()))
    return worst


def check_tiny_train_agreement(device: torch.device, set_loss: str = "", preset: str = "") -> dict:
    """One tiny train step (flips and dropout on, the per-ray core in recomputed chunks) through
    the kernels on the card against the plain versions on the CPU: same weights, same batch, and
    the same random draws, made by a CPU generator with one seed and moved to the card. With
    ``set_loss`` the set radar decoder's model, its association by the host's Hungarian; with
    ``preset`` that preset's model (float32) on the dressed scene (_tiny_pipeline)."""
    gpu, cpu = (_tiny_pipeline(d, TINY_NFF_CHUNKS, set_loss=set_loss, preset=preset) for d in (device, "cpu"))
    _expect(gpu.layout.total % TINY_NFF_CHUNKS == 0, f"{gpu.layout.total} rays do not split in chunks")
    if preset:
        # the camera optimizer away from its zero start on three frames of four, so both branches of the
        # exponential map run
        shape = gpu.model.camera_optimizer.pose_adjustment.shape
        adj = torch.randn(shape, generator=torch.Generator().manual_seed(3))
        adj[::4] = 0.0
        with torch.no_grad():
            gpu.model.camera_optimizer.pose_adjustment.copy_(0.02 * adj)
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    batch = gpu.datamanager.sample_train_batch()
    results = []
    for pipe in (gpu, cpu):
        pipe.model.train()
        pipe.model.zero_grad()
        total, loss_dict, _ = pipe.make_train_loss_fn()(batch, torch.Generator().manual_seed(7))
        total.backward()
        results.append((total, loss_dict))
    (g_total, g_losses), (c_total, c_losses) = results
    worst_loss = 0.0
    for key in ("total", *c_losses):
        g, c = (g_total, c_total) if key == "total" else (g_losses[key], c_losses[key])
        torch.testing.assert_close(g.detach().cpu(), c.detach(), **TRAIN_LOSS_TOL, msg=lambda m, key=key: f"{key}: {m}")
        worst_loss = max(worst_loss, float((g.detach().cpu() - c.detach()).abs()))
    worst_grad, zero_grad, floor_grad = 0.0, {}, {}
    for (name, pg), pc in zip(gpu.model.named_parameters(), cpu.model.parameters()):
        g = pg.grad.cpu() if pg.grad is not None else torch.zeros_like(pc)
        c = pc.grad if pc.grad is not None else torch.zeros_like(pc)
        scale, err = float(c.abs().max()), float((g - c).abs().max())
        atol = ZERO_GRAD if scale < ZERO_GRAD else max(1e-4 * scale, TRAIN_GRAD_ATOL_FLOOR)
        if 0 < scale < ZERO_GRAD:
            zero_grad[name] = {"max_abs_grad": scale, "max_abs_err": err}
        elif scale >= ZERO_GRAD and atol == TRAIN_GRAD_ATOL_FLOOR:
            floor_grad[name] = {"max_abs_grad": scale, "max_abs_err": err}
        torch.testing.assert_close(g, c, rtol=TRAIN_GRAD_RTOL, atol=atol, msg=lambda m, name=name: f"grad {name}: {m}")
        worst_grad = max(worst_grad, err)
    _expect(not set_loss or "radar_aux_loss" in c_losses, f"no radar_aux_loss: {sorted(c_losses)}")
    _expect(not preset or "camera_opt_regularizer" in c_losses, f"no camera_opt_regularizer: {sorted(c_losses)}")
    extra = {}
    if preset:  # pose_adjustment's gradient, held with every other above
        g_pose = gpu.model.camera_optimizer.pose_adjustment.grad.cpu()
        c_pose = cpu.model.camera_optimizer.pose_adjustment.grad
        _expect(float(c_pose.abs().max()) > 0, "pose_adjustment has no gradient")
        extra = {"preset": preset, "pose_adjustment_max_abs_grad": float(c_pose.abs().max()),
                 "pose_adjustment_max_abs_err": float((g_pose - c_pose).abs().max())}
    return {**extra, "nff_chunks": TINY_NFF_CHUNKS, "loss_terms": len(c_losses), "max_abs_err_loss": worst_loss,
            "max_abs_err_grad": worst_grad, "loss_tol": TRAIN_LOSS_TOL, "grad_rtol": TRAIN_GRAD_RTOL,
            "grad_atol_floor": TRAIN_GRAD_ATOL_FLOOR, "zero_grad": ZERO_GRAD, "zero_grad_leaves": zero_grad,
            "floor_leaves": floor_grad, "total": float(c_total.detach())}


def _pinned_assignment(batch: dict, pinned: torch.Tensor) -> torch.Tensor:
    """One fixed association of the batch's GT rows: the auction on the euclidean cost of ``pinned``."""
    gt, gt_mask = torch.from_numpy(batch["radar_gt"]), torch.from_numpy(batch["radar_gt_mask"])
    return radar_utils.auction_assignment(radar_utils.radar_cost_matrix(gt, gt_mask, pinned, "euclidean"), gt_mask)


# the tiny bf16 step card vs CPU, by the rule tests/test_torch_bf16_train.py holds the port to against
# the JAX package: loss terms to rtol 1e-3; each gradient within BF16_GRAD_SHARE of the CPU's own
# bf16-to-float32 distance, in L2 over the parameter (measured: 0.052 at most, the attention key's
# weight); a parameter whose CPU gradient stays under BF16_ZERO_GRAD of the step's largest entry (an
# exact gradient of 0: rounding alone) within BF16_GRAD_FLOOR of that entry (measured: 2.4e-7
# against 2.8e-6); all gradients together within BF16_GRAD_SHARE of the bf16-to-float32 distance
# (measured: 0.0085)
BF16_GRAD_SHARE = 0.125
BF16_ZERO_GRAD = 2e-4
BF16_GRAD_FLOOR = 2e-5
BF16_LOSS_RTOL = 1e-3
# the set model's bf16 step, by the rules tests/test_torch_set_decoder.py holds it to against the JAX
# package: its radar terms come out of five bf16 blocks, so they are held like the gradients, within
# BF16_GRAD_SHARE of the CPU's own bf16-to-float32 distance; the decoder layers' attention query and
# key projections get their gradients through the bf16 softmax backward alone, where two bf16 runs
# round independently, so each is held by its accuracy: |card - CPU float32| <= BF16_ACCURACY x
# |CPU - CPU float32| in L2
SET_RADAR_TERMS = ("radar_loss", "radar_aux_loss")
SOFTMAX_PATH = re.compile(r"radar_decoder\.layer_\d+\.(self_attn|cross_attn)\.(query|key)\.")
BF16_ACCURACY = 1.25
TINY_SET_QUERIES = 24


def check_tiny_bf16_train_agreement(device: torch.device, set_loss: str = "") -> dict:
    """One tiny bf16 step (2 recomputed chunks, 2 radar groups, hoisted cast, flips, dropout and the
    VGG loss on) through the kernels on the card against the plain versions on the CPU, and a float32
    step on the CPU to measure what bf16 itself moves; the radar association solved on one fixed
    cost matrix on all three, since bf16's rounding can flip a near tie of the auction. With
    ``set_loss`` the set radar decoder's model, by SET_RADAR_TERMS and SOFTMAX_PATH's rules."""
    pipes = {"card": _tiny_pipeline(device, TINY_NFF_CHUNKS, "bfloat16", vgg=True, set_loss=set_loss),
             "cpu": _tiny_pipeline("cpu", TINY_NFF_CHUNKS, "bfloat16", vgg=True, set_loss=set_loss),
             "cpu_f32": _tiny_pipeline("cpu", TINY_NFF_CHUNKS, "float32", vgg=True, set_loss=set_loss)}
    state = {k: v.cpu() for k, v in pipes["card"].model.state_dict().items()}
    for name in ("cpu", "cpu_f32"):
        pipes[name].model.load_state_dict(state)
    batch = pipes["card"].datamanager.sample_train_batch()
    layout = pipes["card"].layout
    gen = torch.Generator().manual_seed(5)
    n_mb = TINY_SET_QUERIES if set_loss else layout.rays_per_scan
    pinned = torch.cat([torch.rand((layout.num_radar_scans, n_mb, 1), generator=gen) * 0.6 + 0.2,
                        torch.randn((layout.num_radar_scans, n_mb, 3), generator=gen) * 20,
                        torch.rand((layout.num_radar_scans, n_mb, 3), generator=gen) + 0.5], -1)
    assigned = _pinned_assignment(batch, pinned)
    results = {}
    original = radar_utils.solve_assignment
    radar_utils.solve_assignment = lambda cost, row_mask, method="auction": assigned.to(cost.device)
    try:
        for name, pipe in pipes.items():
            pipe.model.train()
            pipe.model.zero_grad()
            total, losses, _ = pipe.make_train_loss_fn()(batch, torch.Generator().manual_seed(7))
            total.backward()
            results[name] = ({"total": total.detach().cpu(), **{k: v.detach().cpu() for k, v in losses.items()}},
                             {n: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
                              for n, p in pipe.model.named_parameters()})
    finally:
        radar_utils.solve_assignment = original
    (g_loss, g_grad), (c_loss, c_grad), (f_loss, f_grad) = results["card"], results["cpu"], results["cpu_f32"]
    _expect("vgg_loss" in c_loss, "the VGG loss did not run")
    _expect(not set_loss or "radar_aux_loss" in c_loss, f"no radar_aux_loss: {sorted(c_loss)}")
    worst_loss, radar_shares = 0.0, {}
    for key, c in c_loss.items():
        if set_loss and key in SET_RADAR_TERMS:
            radar_shares[key] = float((g_loss[key] - c).abs() / (c - f_loss[key]).abs())
            _expect(radar_shares[key] <= BF16_GRAD_SHARE, f"bf16 {key}: card-CPU share {radar_shares[key]}")
            continue
        torch.testing.assert_close(g_loss[key], c, rtol=BF16_LOSS_RTOL, atol=0,
                                   msg=lambda m, key=key: f"bf16 {key}: {m}")
        worst_loss = max(worst_loss, float((g_loss[key] - c).abs() / c.abs().clamp_min(1e-30)))
    largest = max(float(c.abs().max()) for c in c_grad.values())
    floor = BF16_GRAD_FLOOR * largest
    num = dtype_num = den = 0.0
    shares, floored, accuracy = {}, {}, {}
    for name, c in c_grad.items():
        g, f = g_grad[name], f_grad[name]
        err, dtype_err = float((g - c).norm()), float((c - f).norm())
        max_err, peak = float((g - c).abs().max()), float(c.abs().max())
        if peak < BF16_ZERO_GRAD * largest:
            floored[name] = max_err
            _expect(max_err <= floor, f"bf16 grad {name}: card-CPU {max_err}, floor {floor}")
        elif set_loss and SOFTMAX_PATH.match(name):
            accuracy[name] = float((g - f).norm()) / dtype_err
            _expect(accuracy[name] <= BF16_ACCURACY, f"bf16 grad {name}: accuracy {accuracy[name]}")
        else:
            shares[name] = err / dtype_err
            _expect(err <= BF16_GRAD_SHARE * dtype_err, f"bf16 grad {name}: card-CPU {err}, bf16-float32 {dtype_err}")
        num += err**2
        dtype_num += dtype_err**2
        den += float(c.pow(2).sum())
    _expect(num**0.5 < BF16_GRAD_SHARE * dtype_num**0.5,
            f"bf16 grads: card-CPU {num**0.5}, bf16-float32 {dtype_num**0.5}")
    top = sorted(shares.items(), key=lambda kv: -kv[1])[:3]
    return {"nff_chunks": TINY_NFF_CHUNKS, "radar_groups": 2, "loss_terms": len(c_loss) - 1,
            "max_rel_err_loss": worst_loss, "loss_rtol": BF16_LOSS_RTOL, "radar_term_shares": radar_shares,
            "softmax_path_accuracy": max(accuracy.values(), default=None),
            "grad_rel_l2_card_cpu": (num / den) ** 0.5, "grad_rel_l2_bf16_f32": (dtype_num / den) ** 0.5,
            "grad_share": BF16_GRAD_SHARE, "worst_grad_shares": dict(top),
            "grad_floor": floor, "worst_floored": max(floored.values(), default=0.0), "total": float(c_loss["total"])}


CLI_RUNS = Path("chiprun_out/runs")
CLI_RUN_DIR = CLI_RUNS / "smoke" / "neuradar-synthetic"
CLI_CADENCES = ["--steps_per_eval_batch", "2", "--steps_per_eval_image", "3", "--steps_per_eval_all_images", "4",
                "--steps_per_eval_all_radars", "4", "--steps_per_save", "3", "--steps_per_log", "1"]
# the 0-based indices of the steps after which each cadence fires (cadence c: i >= c, i % c == 0),
# and the step counts the checkpoints carry, in the 6-step run and in its resumption to 8
CLI_EXPECT = {
    "first": {"eval_batch": [2, 4], "eval_image": [3], "all_images": [4], "all_radars": [4], "train_log": list(range(6)),
              "checkpoints": [4, 6]},
    "resumed": {"eval_batch": [6], "eval_image": [6], "all_images": [], "all_radars": [], "train_log": [6, 7],
                "checkpoints": [8]},
}
LIDAR_METRICS = ("depth_median_l2", "depth_mean_rel_l2", "intensity_rmse", "ray_drop_accuracy", "lidar_chamfer_distance")
RADAR_METRICS = ("n_empty_pred_radar", "chamfer_distance_radar_mean", "chamfer_distance_radar_median",
                 "chamfer_distance_radar_std", "emd_distance_radar_mean", "emd_distance_radar_median", "gospa_mean",
                 "gospa_loc_mean", "gospa_missed_mean", "gospa_false_mean")
IMAGE_METRICS = ("psnr", "ssim", "lpips_vggsurrogate", "eval_rays_per_sec", "fps")


def _cadence_steps(events: list) -> dict:
    """The steps at which each cadence logged, by the keys it logs."""
    def steps(key):
        return sorted({e["step"] for e in events if key in e})

    return {"eval_batch": steps("eval_psnr"), "eval_image": steps("eval_image_psnr"), "all_images": steps("ssim"),
            "all_radars": steps("gospa_mean"), "train_log": steps("train_rays_per_sec")}


def cli_train() -> dict:
    """The train command at full width: 6 steps with every cadence, resumed to 8, then the eval command.
    The run's checkpoints stay for cli_render; the caller deletes them."""
    torch.cuda.empty_cache()
    shutil.rmtree(CLI_RUNS, ignore_errors=True)
    run_dir = CLI_RUN_DIR
    base = ["neuradar-synthetic", "--output_dir", str(CLI_RUNS), "--experiment_name", "smoke", *CLI_CADENCES]
    events_path = run_dir / "logs" / "events.jsonl"
    report = {}
    seen = 0
    for run, argv in (("first", [*base, "--max_num_iterations", "6", "--save_only_latest_checkpoint", "false"]),
                      ("resumed", [*base, "--max_num_iterations", "8", "--load_dir", str(run_dir / "checkpoints")])):
        _expect(train_script.main(argv) == 0, f"cli_train {run}: the train command failed")
        gc.collect()
        torch.cuda.empty_cache()
        events = [json.loads(line) for line in events_path.read_text().splitlines()]
        new, seen = events[seen:], len(events)
        got = _cadence_steps(new)
        got["checkpoints"] = sorted(int(c.stem.split("-")[1]) for c in (run_dir / "checkpoints").glob("step-*.pt"))
        report[run] = {"fired": got}
        _expect(got == CLI_EXPECT[run], f"cli_train {run}: cadences {got}, expected {CLI_EXPECT[run]}")
        _expect(all(math.isfinite(v) for e in new for k, v in e.items()),
                f"cli_train {run}: a logged value is not finite")
    eval_path = run_dir / "eval_output.json"
    _expect(eval_script.main(["--load-config", str(run_dir), "--output-path", str(eval_path)]) == 0,
            "cli_train: the eval command failed")
    ev = json.loads(eval_path.read_text())
    results = ev["results"]
    missing = [k for k in (*IMAGE_METRICS, *LIDAR_METRICS, *RADAR_METRICS) if k not in results]
    _expect(not missing, f"cli_train eval: metrics missing: {missing}")
    _expect(all(math.isfinite(v) for v in results.values()), f"cli_train eval: a metric is not finite: {results}")
    _expect(ev["checkpoint_step"] == 8, f"cli_train eval: loaded step {ev['checkpoint_step']}, expected 8")
    report["eval"] = {"results": results, "checkpoint_step": ev["checkpoint_step"]}
    return report


# the render commands on the train command's run (its scene: the preset's synthetic one, 24 frames at
# 96 x 156, 3 eval frames a sensor): the camera paths and the closed-loop server's render at the render
# phase's frame size; the SDF and TSDF grids of 128 voxels a side, the Poisson grid of 64
RENDER_CLI_DIR = Path("build/render_cli")  # deleted at the end: a mesh can take hundreds of MB
RENDER_CLI_HW = (720, 1296)
RENDER_CLI_GRID = 128
RENDER_CLI_POISSON_GRID = 64


def _png_hw(data: bytes) -> list:
    """[height, width] of a PNG, from its header."""
    _expect(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    width, height = struct.unpack(">II", data[16:24])
    return [height, width]


def _pngs(out: Path) -> dict:
    """Every PNG under ``out``: its [height, width], by file name."""
    return {str(p.relative_to(out)): _png_hw(p.read_bytes()) for p in sorted(out.rglob("*.png"))}


def _ply_points(path: Path) -> np.ndarray:
    """The float32 points [N, 3] of a point PLY of exporter.write_ply (no colors)."""
    data = path.read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    return np.frombuffer(data[end:], np.float32).reshape(-1, 3)


def _mesh_counts(path: Path) -> dict:
    verts, faces, colors = meshing.read_ply_mesh(path)
    _expect(np.isfinite(verts).all() and (len(faces) == 0 or (faces.min() >= 0 and faces.max() < len(verts))),
            f"{path}: vertices not finite or faces out of range")
    return {"verts": len(verts), "faces": len(faces), "colored": colors is not None}


def cli_render(run_dir: Path, device: torch.device = torch.device("cuda")) -> dict:
    """The render, export and texture commands on the train command's run, each through its
    main(argv) on the card in this process, then the closed-loop server on a free port of localhost:
    /info, /actors, an actor edit and a /render of RENDER_CLI_HW. Each command's output counts; every
    frame, scan, point cloud and mesh must be present and finite."""
    out = RENDER_CLI_DIR
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    pipe = render_command.load_pipeline(run_dir, device)
    cam = int(pipe.datamanager.eval_camera_indices()[0])
    c2w = np.asarray(pipe.outputs.camera_to_worlds[cam], np.float32)
    r2w = np.asarray(pipe.outputs.radar_to_worlds, np.float32)
    scans = [int(i) for i in pipe.datamanager.eval_radar_indices()][:2]

    def path_file(name, poses, **spec):
        f = out / f"{name}.json"
        f.write_text(json.dumps({"camera_path": [{"camera_to_world": np.concatenate([p[:3], [[0, 0, 0, 1]]]).reshape(
            -1).tolist()} for p in poses], **spec}))
        return str(f)

    h, w = RENDER_CLI_HW
    cam_path = path_file("camera_path", [c2w], render_height=h, render_width=w)
    ods_path = path_file("ods_path", [c2w], render_height=h, render_width=w, camera_type="omnidirectional")
    radar_path = path_file("radar_path", [r2w[i] for i in scans])
    # the commands render on the card by default; a rehearsal on the CPU names its device
    run = ["--load-config", str(run_dir), *(["--device", str(device)] if device.type != "cuda" else [])]
    exports = out / "exports"
    commands = [
        *(("render", cmd, render_command, [cmd, *run, "--output-dir", str(out / "camera"), *extra])
          for cmd, extra in (("dataset", ["--max-frames", "2"]), ("lane-shift", ["--max-frames", "1"]),
                             ("actor-shift", ["--max-frames", "1", "--actor-remove"]),
                             ("interpolated", ["--max-frames", "2", "--steps-per-transition", "2"]),
                             ("spiral", ["--max-frames", "2"]))),
        ("render", "camera-path", render_command, ["camera-path", *run, "--output-dir", str(out / "camera"),
                                                   "--camera-path-filename", cam_path]),
        ("render", "camera-path-ods", render_command, ["camera-path", *run, "--output-dir", str(out / "camera_ods"),
                                                       "--camera-path-filename", ods_path]),
        *(("render_radar", cmd, render_radar_command, [cmd, *run, "--output-dir", str(out / "radar"), "--max-scans",
                                                       "2", *extra])
          for cmd, extra in (("dataset", []), ("pose-shift", []), ("actor-shift", ["--actor-lateral", "2.0"]),
                             ("interpolated", []), ("full-sensor-set", []),
                             ("camera-path", ["--camera-path-filename", radar_path]))),
        *(("exporter", cmd, exporter_command, [cmd, *run, "--output-path", str(exports / f"{cmd}.ply"), "--max-scans",
                                               "2", "--grid-resolution", str(grid)])
          for cmd, grid in (("pointcloud", RENDER_CLI_GRID), ("radar-pointcloud", RENDER_CLI_GRID),
                            ("cameras", RENDER_CLI_GRID), ("sdf-surface", RENDER_CLI_GRID), ("sdf-mesh", RENDER_CLI_GRID),
                            ("tsdf-mesh", RENDER_CLI_GRID), ("poisson-mesh", RENDER_CLI_POISSON_GRID))),
        ("texture", "texture", texture_command, [*run, "--input-mesh", str(exports / "sdf-mesh.ply"), "--output-path",
                                                 str(exports / "textured.ply"), "--max-cameras", "2"]),
    ]
    report = {"commands": []}
    for script, name, module, argv in commands:
        seen = set(out.rglob("*"))
        _expect(module.main(argv) == 0, f"cli_render: {script} {name} failed")
        written = sorted(p for p in set(out.rglob("*")) - seen if p.is_file())
        counts = {"files": len(written), "pngs": sum(p.suffix == ".png" for p in written)}
        for p in written:
            if p.suffix == ".json" and p.parent.name in ("dataset", "pose-shift", "actor-shift", "interpolated",
                                                         "camera-path") and script == "render_radar":
                pts = np.asarray(json.loads(p.read_text())["points"], np.float64).reshape(-1, 3)
                _expect(np.isfinite(pts).all(), f"cli_render: {p} has points that are not finite")
                counts["radar_points"] = counts.get("radar_points", 0) + len(pts)
                counts["scans"] = counts.get("scans", 0) + 1
            elif p.suffix == ".ply" and script in ("exporter", "render_radar") and not p.stem.endswith("mesh"):
                pts = _ply_points(p)
                _expect(np.isfinite(pts).all(), f"cli_render: {p} has points that are not finite")
                counts[f"{p.stem}_points"] = len(pts)
            elif p.suffix == ".ply":
                counts[p.stem] = _mesh_counts(p)
        report["commands"].append({"script": script, "command": name, **counts})
        phase("cli_render_command", **report["commands"][-1])
        _expect(counts["files"] > 0, f"cli_render: {script} {name} wrote nothing")

    frames = _pngs(out / "camera")
    u = pipe.config.model.rgb_upsample_factor
    H, W = pipe.outputs.image_size
    _expect(frames["camera_path/frame_00000.png"] == [h, w]
            and _pngs(out / "camera_ods")["camera_path/frame_00000.png"] == [2 * h, w]
            and frames[f"dataset/frame_{cam:05d}.png"] == [H // u * u, W // u * u]
            and sum(k.startswith("interpolated/") for k in frames) == 2,
            f"cli_render: frames {frames}")
    by_cmd = {(c["script"], c["command"]): c for c in report["commands"]}
    _expect(by_cmd[("render_radar", "dataset")].get("scans") == len(scans)
            and by_cmd[("exporter", "pointcloud")]["pointcloud_points"] > 0
            and by_cmd[("exporter", "sdf-surface")]["sdf-surface_points"] > 0
            and by_cmd[("exporter", "sdf-mesh")]["sdf-mesh"]["faces"] > 0
            and by_cmd[("exporter", "tsdf-mesh")]["tsdf-mesh"]["faces"] > 0
            and by_cmd[("exporter", "poisson-mesh")]["poisson-mesh"]["faces"] > 0
            and by_cmd[("texture", "texture")]["textured"]["colored"],
            f"cli_render: counts {report['commands']}")

    # the closed-loop server, and the full-frame render_pose it serves
    state = closed_loop.ClosedLoopState(pipe)
    server = closed_loop.serve(state, 0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=300)

        def request(method, path, body=None):
            conn.request(method, path, body=None if body is None else json.dumps(body))
            resp = conn.getresponse()
            return resp.status, resp.getheader("Content-Type"), resp.read()

        status, _, info = request("GET", "/info")
        _expect(status == 200 and json.loads(info)["image_size"] == [H, W], f"/info: {status} {info[:200]}")
        status, _, actors = request("GET", "/actors")
        n_actors = len(json.loads(actors)["trajectories"])
        _expect(status == 200 and n_actors == len(pipe.outputs.trajectories), f"/actors: {status}")
        _expect(request("POST", "/actors", {"index": 0, "lateral": 1.0, "rotation": 0.2})[0] == 200, "POST /actors")
        time_s = float(pipe.outputs.camera_times[cam])
        status, ctype, png = request("POST", "/render", {"pose": c2w.tolist(), "time": time_s, "hw": [h, w]})
        _expect(status == 200 and ctype == "image/png" and _png_hw(png) == [h, w],
                f"/render: {status} {ctype} {png[:200] if status != 200 else _png_hw(png)}")
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    rgb = pipe.render_pose(c2w, hw=RENDER_CLI_HW, time_s=time_s, actor_edits=state.edits)
    _expect(rgb.shape == (h, w, 3), f"render_pose: {rgb.shape}")
    report["server"] = {"png_bytes": len(png), "hw": [h, w], "actors": n_actors}
    report["render_pose_full_frame"] = {"hw": [h, w], "rays": (h // u) * (w // u)}
    shutil.rmtree(out, ignore_errors=True)
    del pipe, state
    gc.collect()
    torch.cuda.empty_cache()
    return report


def check_tiny_render_pose_agreement(device: torch.device) -> dict:
    """The tiny pipeline's render_pose on the card against the CPU (same weights): the float renders
    of pose_camera's table for a perspective, a fisheye, an equirectangular and an ODS camera, with a
    scene time and an actor edit, to TINY_TOL; the uint8 images within one unit."""
    gpu, cpu = _tiny_pipeline(device), _tiny_pipeline("cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    c2w = np.asarray(cpu.outputs.camera_to_worlds[2], np.float32)
    edits = ActorEdits(lateral=1.5, rotation=0.3)
    worst, worst_u8 = 0.0, 0
    for camera_type in (CameraType.PERSPECTIVE, CameraType.FISHEYE, CameraType.EQUIRECTANGULAR,
                        CameraType.OMNIDIRECTIONALSTEREO_L):
        rend = {}
        for name, pipe in (("gpu", gpu), ("cpu", cpu)):
            cameras, grid = pipe.pose_camera(c2w, (24, 36), time_s=1.0, camera_type=int(camera_type))
            with torch.inference_mode():
                rend[name] = pipe.render_grid(cameras, 0, grid, edits)
        for key in ("rgb", "depth", "accumulation"):
            g, c = rend["gpu"][key].cpu(), rend["cpu"][key]
            torch.testing.assert_close(g, c, **TINY_TOL, msg=lambda m, key=key: f"render_pose {camera_type} {key}: {m}")
            worst = max(worst, float((g - c).abs().max()))
        u8 = [p.render_pose(c2w, hw=(24, 36), time_s=1.0, camera_type=int(camera_type), actor_edits=edits)
              for p in (gpu, cpu)]
        worst_u8 = max(worst_u8, int(np.abs(u8[0].astype(np.int64) - u8[1]).max()))
    _expect(worst_u8 <= 1, f"render_pose uint8 images differ by {worst_u8}")
    return {"max_abs_err": worst, "max_uint8_diff": worst_u8, **TINY_TOL}


# the JAX package's tiny learning curve on the CPU (bfloat16, 4 steps a dispatch), for comparison only,
# and its curve with the host's Hungarian association
JAX_CURVE = Path("artifacts/learning_curve_cpu_tiny_20k.json")
JAX_HUNGARIAN_CURVE = Path("artifacts/curve_tiny_hungarian_2500.json")
LEARNING_KEYS = ("loss", "psnr", "depth_loss", "radar_loss")


def _quarters(points: list) -> dict:
    """validate_learning's first- and last-quarter means of [step, value] points."""
    q = max(len(points) // 4, 1)
    return {"first": sum(v for _, v in points[:q]) / q, "last": sum(v for _, v in points[-q:]) / q}


def _first_300(path: Path) -> dict:
    curves = json.loads(path.read_text())["curves"]
    return {k: _quarters([p for p in curves[k] if p[0] < 300]) for k in LEARNING_KEYS}


def learning() -> dict:
    """The tiny learning check on the card, 300 steps each: at bf16 (the JAX curve's dtype, the
    default) and at float32, with the JAX package's CPU curve beside them; then at bf16 with the set
    radar decoder, and with the host's Hungarian beside the JAX package's Hungarian curve."""
    jax_curves = json.loads(JAX_CURVE.read_text())["curves"]
    jax = _first_300(JAX_CURVE)
    result = {"jax_cpu_bf16_first_300": jax, "jax_cpu_bf16_hungarian_first_300": _first_300(JAX_HUNGARIAN_CURVE)}
    for name, flags in (("bfloat16", ["--bf16"]), ("float32", ["--no-bf16"]), ("set_decoder", ["--set-decoder"]),
                        ("hungarian", ["--radar-assignment", "hungarian"])):
        out_dir = Path("chiprun_out/learning") / name
        shutil.rmtree(out_dir, ignore_errors=True)
        rc = validate_learning.main(["--scale", "tiny", "--iters", "300", "--eval-every", "50", "--device", "cuda",
                                     "--output-dir", str(out_dir), *flags])
        _expect(rc == 0, f"learning {name}: LEARNING CHECK did not PASS")
        (report_path,) = out_dir.glob("*/neuradar/learning_check.json")
        report = json.loads(report_path.read_text())
        result[name] = {"port": {k: report[k] for k in LEARNING_KEYS},
                        "set_decoder": report["set_decoder"], "radar_assignment": report["radar_assignment"],
                        "curve_keys": report.get("curve_keys"),
                        "jax_curve_keys_missing": sorted(set(jax_curves) - set(report.get("curve_keys", [])))}
    return result


SPLAT_PRESET = "splatfacto-big"
SPLAT_START_STEP = 15000
SPLAT_STEPS = 5
SPLAT_PLAIN_ROWS = 256  # the top 16 tile rows: the plain backward's comparison
sys.path.insert(0, str(Path(__file__).resolve().parent / "benchmark"))
from harness.splat_count import SplatLayout, raster_bwd as k5_bwd_count, raster_fwd as k5_fwd_count  # noqa: E402


def _splat_trainer(device: torch.device):
    """splatfacto-big as the registry builds it, on the synthetic scene in VoD's camera (1936 x 1216,
    whole tiles), its 1,048,576 gaussians all alive: the lidar returns repeated and jittered by
    0.3 m, log-scales around log 0.2 m (std 0.3 an axis), random rotations, opacities uniform in
    [0.05, 0.95], normal colour logits and SH bands of std 0.1; at step 15,000."""
    trainer = get_method(SPLAT_PRESET).setup(vod_sensor_scene_outputs(), device)
    out = trainer.outputs
    pts = np.concatenate([p[np.linalg.norm(p[:, :3], axis=1) < 1e3, :3] @ l2w[:3, :3].T + l2w[:3, 3]
                          for p, l2w in zip(out.lidar_points, out.lidar_to_worlds)])
    gen = torch.Generator(device=device).manual_seed(0)
    G = trainer.config.model.max_gaussians

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    base = torch.as_tensor(pts, dtype=torch.float32, device=device)[torch.arange(G, device=device) % len(pts)]
    values = {"means": base + 0.3 * randn(G, 3), "log_scales": math.log(0.2) + 0.3 * randn(G, 3),
              "quats": randn(G, 4), "opacity_logits": torch.logit(0.05 + 0.9 * torch.rand(G, 1, generator=gen,
                                                                                          device=device)),
              "rgb_logits": randn(G, 3), "sh_rest": 0.1 * randn(G, 45)}
    with torch.no_grad():
        for k, v in trainer.model.params.items():
            v.copy_(values[k])
        trainer.model.alive.fill_(True)
    trainer.step = SPLAT_START_STEP
    return trainer


def _splat_inputs(trainer, height: int):
    """K5's inputs on the trainer's first image, cut to its top ``height`` rows."""
    mc, cam = trainer.config.model, trainer.camera(0)
    with torch.no_grad():
        feats, radius, in_view = sf.features(trainer.model.params, trainer.model.alive, cam["w2c"], cam["fx"],
                                             cam["fy"], cam["cx"], cam["cy"], height, trainer.W, mc.sh_degree)
    return feats.contiguous(), radius.contiguous(), in_view


def _column_gaps(got: torch.Tensor, want: torch.Tensor) -> list:
    """Each column's relative L2 gap."""
    return [float((g - w).double().norm() / w.double().norm().clamp(min=1e-30)) for g, w in zip(got.T, want.T)]


def k5_rows(trainer) -> list:
    """K5 against its plain version at splatfacto-big's shapes (phase 3b)."""
    mc = trainer.config.model
    H, W, K = trainer.H, trainer.W, mc.tile_top_k
    th, tw = splat.tile_grid(H, W)
    feats, radius, in_view = _splat_inputs(trainer, H)
    lists = splat.bin_sort(feats, radius, in_view, th, tw, K)
    gids, start, counts, (listed, overflowed) = lists
    layout = SplatLayout(gaussians=mc.max_gaussians, height=H, width=W, top_k=K, sh_degree=mc.sh_degree)
    shape = [th * tw, splat.TILE * splat.TILE, K]
    base = {"path": "train_splatfacto-big", "shape": shape, "listed_pairs": listed, "tiles_overflowed": overflowed,
            "pairs": int(len(gids)), "in_view": int(in_view.sum())}
    rows = [{"name": "splat_bin_sort", **base, "call_ms": call_ms(lambda: splat.bin_sort(feats, radius, in_view,
                                                                                           th, tw, K), reps=5)}]

    def fwd():
        return splat.raster_fwd(feats, gids, start, counts, K, tw, H, W)

    outputs = fwd()
    with torch.no_grad():
        plain = splat.render_plain(feats, radius, in_view, H, W, K)
    fwd_gap = {name: float((o - p).abs().max()) for name, o, p in zip(("color", "alpha", "depth"), outputs, plain)}
    rows.append({"name": "splat_raster_fwd", **base, "ms": device_ms(fwd), "call_ms": call_ms(fwd),
                 "plain_ms": call_ms(lambda: splat.render_plain(feats, radius, in_view, H, W, K), reps=1, warmup=1),
                 "plain_timer": "one call", "max_abs_gap": fwd_gap, **_bound(*k5_fwd_count(listed, layout))})

    gen = torch.Generator(device=trainer.device).manual_seed(1)
    grads = [torch.randn(o.shape, generator=gen, device=trainer.device) for o in outputs]
    bwd_ms = device_ms(lambda: splat.raster_bwd(feats, gids, start, counts, K, tw, H, W, outputs, grads))

    # the backward against the plain version's on the top rows
    h = SPLAT_PLAIN_ROWS
    cf, cr, cv = _splat_inputs(trainer, h)
    cg, cs, cc, (c_listed, _) = splat.bin_sort(cf, cr, cv, h // splat.TILE, tw, K)
    c_out = splat.raster_fwd(cf, cg, cs, cc, K, tw, h, W)
    c_grads = [torch.randn(o.shape, generator=gen, device=trainer.device) for o in c_out]
    got = splat.raster_bwd(cf, cg, cs, cc, K, tw, h, W, c_out, c_grads)
    leaf = cf.clone().requires_grad_(True)

    def plain_bwd():
        leaf.grad = None
        color, alpha, depth, _ = splat.render_plain(leaf, cr, cv, h, W, K)
        torch.autograd.backward((color, alpha, depth), c_grads)
        return leaf.grad

    want = plain_bwd()
    gaps = _column_gaps(got, want)
    plain_ms = call_ms(plain_bwd, reps=1, warmup=1)
    rows.append({"name": "splat_raster_bwd", **base, "ms": bwd_ms, "plain_ms_top_rows": plain_ms,
                 "plain_timer": f"one call on the top {h} rows", "top_rows_listed_pairs": c_listed,
                 "grad_column_gaps": dict(zip(("x", "y", "ia", "ib", "ic", "opacity", "r", "g", "b", "depth"), gaps)),
                 **_bound(*k5_bwd_count(listed, layout))})
    return rows


def check_k5_rows(rows: list) -> None:
    """K5 forward within 1e-3 of the plain version (colour, alpha, depth), backward within 1e-2 a
    feature column (relative L2): the sums run in other orders, the backward's through atomics."""
    fwd, bwd = rows[1]["max_abs_gap"], rows[2]["grad_column_gaps"]
    _expect(all(math.isfinite(v) and v < 1e-3 for v in fwd.values()), f"K5 forward against plain: {fwd}")
    _expect(all(math.isfinite(g) and g < 1e-2 for g in bwd.values()), f"K5 backward against plain: {bwd}")


def train_splat(trainer) -> dict:
    """splatfacto-big's train step from the trainer's state (phase 3c)."""
    before = {k: v.detach().clone() for k, v in trainer.model.params.items()}
    losses = []
    with trace.recording():
        for _ in range(SPLAT_STEPS):
            loss, metrics = trainer.train_step()
            losses.append(float(loss["total"]))
        launches = _launches(trace.snapshot())
    changed = {k: bool((v.detach() != before[k]).any()) for k, v in trainer.model.params.items()}
    _expect(all(changed.values()) and all(math.isfinite(v) for v in losses), f"train_splat: {changed} {losses}")
    _expect(launches == {k: SPLAT_STEPS for k in ("splat_bin_count", "splat_bin_emit", "splat_raster_fwd",
                                                  "splat_raster_bwd")}, f"train_splat: launches {launches}")
    return {"pixels_per_step": trainer.H * trainer.W, "losses": losses,
            "tile_overflow_frac": float(metrics["tile_overflow_frac"]), "alive": int(trainer.model.alive.sum()),
            "launches": launches, "changed": changed}


def train_presets(device: torch.device) -> tuple:
    """The PRESETS (neuradar and neurad) on the ZOD-camera scene through ``train_preset``, each path's
    launches checked: K1 on every train path, K2 at bf16 exactly where there is radar and never the float32
    K2, and on neuradar's eval frame and radar scan only their kernels. Returns K4's rows and the launches
    by path."""
    scene = zod_camera_scene_outputs()
    rows, preset_launches = [], {}
    for name in PRESETS:
        report = train_preset(device, name, scene)
        preset_launches.update(report["launches"])
        rows.extend(report.pop("k4"))
        phase("train_presets", preset=name, **report)
        got = _kernels(report["launches"][f"train_{name}"])
        _expect({"composite_sky_fwd", "composite_sky_bwd"} <= got, f"{name}: K1 never launched: {got}")
        _expect(not F32_K2 & got, f"{name} launched the float32 K2")
        radar = name != "neurad"
        _expect({"self_attention_bf16_fwd", "self_attention_bf16_bwd"} <= got if radar
                else not {"self_attention_bf16_fwd", "self_attention_bf16_bwd"} & got,
                f"{name}: K2 at bf16 launches {got}, radar {radar}")
    for path, kernels in (("render_neuradar", {"composite_sky_fwd", "hash_encode_fwd"}),
                          ("render_radar_neuradar", {"composite_sky_fwd", "self_attention_bf16_fwd", "hash_encode_fwd"})):
        got = preset_launches[path]
        _expect(_kernels(got) == kernels, f"{path}: launches {got}")
    return rows, preset_launches


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda,
          matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
          cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    lib = build.build(verbose=True)
    build.load()
    phase("build", library=str(lib.name))

    if argv == ["k4"]:
        # K4 alone: the presets' steps, eval frame and radar scan, with K4's rows on their own encodes
        rows, launches = train_presets(device)
        for row in rows:
            row["launches"] = launches[row["path"]].get(_symbol(row), 0)
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0

    trainer = _splat_trainer(device)
    phase("k5_setup", gaussians=trainer.config.model.max_gaussians, image=[trainer.H, trainer.W])
    splat_rows = k5_rows(trainer)
    for row in splat_rows:
        phase("kernel", **row)
    report = train_splat(trainer)
    phase("train_splat", **report)
    check_k5_rows(splat_rows)
    for row in splat_rows:
        row["launches"] = report["launches"][_symbol(row)] // SPLAT_STEPS
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    if argv == ["splat"]:
        print(json.dumps({"kernels": splat_rows}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0

    rows = check_kernels(device) + splat_rows
    for row in rows[:-len(splat_rows)]:
        phase("kernel", **row)

    with trace.recording():
        render_full_width(device)
        render_launches = _launches(trace.snapshot())
    phase("render", launches=render_launches)
    render_kernels = {"composite_sky_fwd", "self_attention_fwd", "hash_encode_fwd"}
    _expect(render_kernels <= _kernels(render_launches),
            f"a kernel of the render path never launched: {render_launches}")

    with trace.recording():
        train_full_width(device)
        launches = _launches(trace.snapshot())
    phase("train", launches=launches)
    _expect(PATH_KERNELS <= _kernels(launches), f"a kernel of the train path never launched: {launches}")

    report = train_bf16(device)
    bf16_launches = report["launches"]
    phase("train_bf16", **report)
    _expect(BF16_PATH_KERNELS <= _kernels(bf16_launches["train_bf16"]),
            f"a kernel of the bf16 train path never launched: {bf16_launches}")

    report = train_set(device)
    set_launches = report["launches"]
    phase("train_set", **report)
    _expect(BF16_PATH_KERNELS <= _kernels(set_launches["train_set"]),
            f"a kernel of the set decoder's train path never launched: {set_launches}")
    # the renders: K1 and K4 forward alone on the bench frame; K1, K2 at bf16 and K4 forward on the radar scans
    for path, kernels in (("render_bf16", {"composite_sky_fwd", "hash_encode_fwd"}),
                          ("render_radar_set", {"composite_sky_fwd", "self_attention_bf16_fwd", "hash_encode_fwd"}),
                          ("eval_radar_set", {"composite_sky_fwd", "self_attention_bf16_fwd", "hash_encode_fwd"})):
        got = {**bf16_launches, **set_launches}[path]
        _expect(_kernels(got) == kernels, f"{path}: launches {got}")
    for path, got in (*bf16_launches.items(), *set_launches.items()):
        _expect(not F32_K2 & _kernels(got), f"{path} launched the float32 K2")

    preset_rows, preset_launches = train_presets(device)
    rows.extend(preset_rows)

    # VoD's preset on the synthetic scene in VoD's sensors: 127,744 rays a step, 4,400 a radar scan;
    # then the shifted-view FIDs of 2 eval frames (8 renders each: 3 lane shifts, 1 vertical, 4 actor edits)
    report = train_preset(device, VOD_PRESET, vod_sensor_scene_outputs(), fid_frames=VOD_FID_FRAMES)
    preset_launches.update(report["launches"])
    rows.extend(report.pop("k4"))
    setup = report["setup"]
    phase("train_vod", preset=VOD_PRESET, **report)
    _expect(setup["rays_per_step"] == VOD_STEP_RAYS and report["render_radar"]["shape"] == [VOD_SCAN_RAYS, 7],
            f"{VOD_PRESET}: {setup['rays_per_step']} rays a step, radar {report['render_radar']['shape']}")
    for path, kernels in ((f"train_{VOD_PRESET}", BF16_PATH_KERNELS),
                          (f"render_{VOD_PRESET}", {"composite_sky_fwd", "hash_encode_fwd"}),
                          (f"render_radar_{VOD_PRESET}", {"composite_sky_fwd", "self_attention_bf16_fwd",
                                                           "hash_encode_fwd"}),
                          (f"fid_{VOD_PRESET}", {"composite_sky_fwd", "hash_encode_fwd"})):
        got = report["launches"][path]
        _expect(_kernels(got) == kernels, f"{path}: launches {got}")
    phase("train_presets_agreement", **check_tiny_train_agreement(device, preset="neurad"))

    phase("agreement", max_abs_err=check_tiny_agreement(device), **TINY_TOL)
    phase("render_pose_agreement", **check_tiny_render_pose_agreement(device))
    phase("train_agreement", **check_tiny_train_agreement(device))
    phase("train_bf16_agreement", **check_tiny_bf16_train_agreement(device))
    for set_loss in ("detr", "mb"):
        phase("train_set_agreement", set_loss=set_loss, **check_tiny_train_agreement(device, set_loss))
        phase("train_set_bf16_agreement", set_loss=set_loss, **check_tiny_bf16_train_agreement(device, set_loss))

    try:
        with trace.recording():
            report = cli_train()
            cli_launches = _launches(trace.snapshot())
        phase("cli_train", launches=cli_launches, **report)
        _expect(PATH_KERNELS <= _kernels(cli_launches), f"a kernel of the train command never launched: {cli_launches}")
        # the render and export commands on that run: K1, K4 and the float32 K2 forward alone
        with trace.recording():
            report = cli_render(CLI_RUN_DIR)
            render_cli_launches = _launches(trace.snapshot())
        phase("cli_render", launches=render_cli_launches, **report)
        _expect(_kernels(render_cli_launches) == {"composite_sky_fwd", "self_attention_fwd", "hash_encode_fwd"},
                f"render_cli: launches {render_cli_launches}")
    finally:
        shutil.rmtree(CLI_RUN_DIR / "checkpoints", ignore_errors=True)  # ~1.8 GB each; the logs stay

    phase("learning", **learning())

    path_launches = {"render": render_launches, "train": launches, **bf16_launches, **set_launches,
                     **preset_launches, "render_cli": render_cli_launches}
    for row in rows:
        if row["path"] != "standalone" and "launches" not in row:
            row["launches"] = path_launches[row["path"]].get(_symbol(row), 0)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
