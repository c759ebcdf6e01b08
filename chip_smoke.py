"""Smoke run of the PyTorch port (neuradar_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each before the final JSON line:
  1. device: requires CUDA; prints the card's name and power limit (nvidia-smi)
     and turns TF32 off for matmuls and convolutions;
  2. build: compiles the CUDA kernels from neuradar_tpu_torch/csrc with nvcc;
  3. kernels: K1 (composite_sky_fwd) and K2 (self_attention_fwd) against their
     plain PyTorch versions at the render path's shapes, with CUDA-event times;
  4. render: the neuradar-synthetic model at full width with seeded random
     weights renders 2 camera frames at 720 x 1296, one 16,384-ray lidar scan
     and 4 radar scans; the launch counts show both kernels ran on that path;
  5. agreement: a tiny scene rendered through the kernels on the card and
     through the plain versions on the CPU, with the same weights.
The last line is {"ok": true, "device": {...}}. Any failure raises, and the
script exits non-zero without printing it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from neuradar_tpu_torch.data.dataparsers.synthetic import SyntheticDataParser, SyntheticDataParserConfig
from neuradar_tpu_torch.ops import build
from neuradar_tpu_torch.ops.attention import attention_reference, self_attention_fwd
from neuradar_tpu_torch.ops.volumetric import composite_sky_fwd, composite_sky_reference
from neuradar_tpu_torch.pipelines.ad_neuradar_pipeline import ADNeuRadarPipeline, ADNeuRadarPipelineConfig

K1_TOL = dict(rtol=1e-5, atol=1e-6)
K2_TOL = dict(rtol=1e-4, atol=1e-5)  # online softmax sums in another order than the plain version
TINY_TOL = dict(rtol=1e-4, atol=1e-4)


def phase(label: str, /, **fields) -> None:
    print(json.dumps({"phase": label, **fields}), flush=True)


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over `reps` launches, each timed with its own pair of CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernels(device: torch.device) -> list:
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []

    R, S, C = 32768, 33, 32  # one camera chunk: 32 NeRF samples + the sky sample, nff_out_dim 32
    alpha = torch.rand((R, S), generator=gen, device=device)
    feats = torch.randn((R, S, C), generator=gen, device=device)
    got = composite_sky_fwd(alpha, feats)
    want = composite_sky_reference(alpha, feats)
    for g, w, name in zip(got, want, ("w_sky", "features", "accum")):
        torch.testing.assert_close(g, w, **K1_TOL, msg=lambda m, name=name: f"K1 {name}: {m}")
    rows.append({
        "name": "composite_sky_fwd", "route": "cuda", "source": "neuradar_tpu_torch/csrc/composite_sky.cu",
        "replaces": "neuradar_tpu/ops/volumetric.py:51",
        "shape": [R, S, C],
        "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, want)),
        "ms": cuda_time_ms(lambda: composite_sky_fwd(alpha, feats)),
        "plain_ms": cuda_time_ms(lambda: composite_sky_reference(alpha, feats)),
    })

    B, S, D = 4, 3531, 48  # 4 radar scans of the ZOD FoV, d_model 48, one head
    q, k, v = (torch.randn((B, S, D), generator=gen, device=device) for _ in range(3))
    got = self_attention_fwd(q, k, v)
    want = attention_reference(q, k, v)
    torch.testing.assert_close(got, want, **K2_TOL, msg=lambda m: f"K2: {m}")
    rows.append({
        "name": "self_attention_fwd", "route": "cuda", "source": "neuradar_tpu_torch/csrc/attention.cu",
        "replaces": "neuradar_tpu/ops/attention.py:119",
        "shape": [B, S, D],
        "max_abs_err": float((got - want).abs().max()),
        "ms": cuda_time_ms(lambda: self_attention_fwd(q, k, v)),
        "plain_ms": cuda_time_ms(lambda: attention_reference(q, k, v)),
    })
    return rows


def _finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x).all())


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def render_full_width(device: torch.device) -> None:
    """The main path: full-width neuradar-synthetic, seeded random weights."""
    t0 = time.perf_counter()
    out = SyntheticDataParser(SyntheticDataParserConfig(
        num_frames=4, image_height=720, image_width=1296, lidar_points_per_scan=16384, seed=0,
    )).get_dataparser_outputs()
    pipe = ADNeuRadarPipeline(ADNeuRadarPipelineConfig(), out, device, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.model.parameters())
    phase("render_setup", seconds=time.perf_counter() - t0, n_params=n_params,
          rays_per_radar_scan=pipe.tables.radars.rays_per_scan)

    # the 4-frame scene's eval split is frame 0 alone; frame 3 is the second render
    for cam_idx in (0, 3):
        rend, dt = _timed(lambda: pipe.render_camera(cam_idx))
        shapes = {k: list(v.shape) for k, v in rend.items()}
        finite = all(_finite(v) for v in rend.values())
        phase("render_camera", cam_idx=cam_idx, shapes=shapes, finite=finite, seconds=dt,
              rays=int(rend["depth"].numel()))
        _expect(finite and shapes["rgb"] == [720, 1296, 3] and shapes["depth"] == [240, 432],
                f"render_camera {cam_idx}: {shapes}, finite={finite}")

    rend, dt = _timed(lambda: pipe.render_lidar(0, max_points=16384))
    shapes = {k: list(rend[k].shape) for k in ("depth", "intensity", "ray_drop_prob")}
    finite = all(_finite(rend[k]) for k in shapes)
    phase("render_lidar", shapes=shapes, finite=finite, seconds=dt, num_valid=rend["num_valid"])
    _expect(finite and all(s == [16384, 1] for s in shapes.values()), f"render_lidar: {shapes}, finite={finite}")

    rend, dt = _timed(lambda: pipe.render_radar([0, 1, 2, 3]))
    ro = rend["radar_output"]
    finite = _finite(ro)
    phase("render_radar", shape=list(ro.shape), finite=finite, seconds=dt)
    _expect(finite and list(ro.shape) == [4, pipe.tables.radars.rays_per_scan, 7],
            f"render_radar: {list(ro.shape)}, finite={finite}")
    del pipe
    torch.cuda.empty_cache()


def _tiny_pipeline(device) -> ADNeuRadarPipeline:
    out = SyntheticDataParser(SyntheticDataParserConfig(
        num_frames=8, image_height=24, image_width=36, lidar_points_per_scan=256)).get_dataparser_outputs()
    out.radar_fov = dict(min_azimuth=-0.8, max_azimuth=0.8, min_elevation=-0.08, max_elevation=0.32,
                         azimuth_step=0.1, elevation_step=0.1)
    cfg = ADNeuRadarPipelineConfig()
    m = cfg.model
    m.field.grid.static.log2_hashmap_size = 12
    m.field.grid.actor.log2_hashmap_size = 10
    for pf in (m.sampling.proposal_field_1, m.sampling.proposal_field_2):
        pf.grid.static.log2_hashmap_size = 11
        pf.grid.actor.log2_hashmap_size = 9
    m.sampling.num_proposal_samples = (16, 8)
    m.sampling.num_nerf_samples = 6
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


def main() -> int:
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

    t0 = time.perf_counter()
    lib = build.build(verbose=True)
    build.load()
    phase("build", seconds=time.perf_counter() - t0, library=str(lib.name))

    rows = check_kernels(device)
    for row in rows:
        phase("kernel", **row)

    kernels = (composite_sky_fwd, self_attention_fwd)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    render_full_width(device)
    launches = {k.__name__: k.launches for k in kernels}
    phase("render", seconds=time.perf_counter() - t0, launches=launches,
          peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    _expect(all(n > 0 for n in launches.values()), f"a kernel of the render path never launched: {launches}")

    phase("agreement", max_abs_err=check_tiny_agreement(device), **TINY_TOL)

    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
