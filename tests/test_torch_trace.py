"""The port's spans and counters (``neuradar_tpu_torch/utils/trace.py``) on the CPU: when they are
recorded, how a request's and a train step's spans nest and share an id, and that routing a hash
grid encode's corner gathers through the ``hash_encode/scatter`` span leaves the tables' gradients
bit-equal to autograd's own, and that every hand-written kernel's launch is counted in one place,
``ops/build.check``."""

import threading

import numpy as np
import pytest
import torch

from neuradar_tpu_torch.data import datamanager as t_dm
from neuradar_tpu_torch.data.dataparsers import synthetic as t_synthetic
from neuradar_tpu_torch.engine import optimizers as t_opt
from neuradar_tpu_torch.engine.trainer import Trainer, TrainerConfig
from neuradar_tpu_torch.field_components import encodings
from neuradar_tpu_torch.ops import build
from neuradar_tpu_torch.pipelines import ad_neuradar_pipeline as t_pipeline
from neuradar_tpu_torch.utils import trace
from tests.test_torch_slice import RADAR_FOV, SCENE, shrink

DM = dict(num_rgb_patches=2, patch_size=4, num_lidar_rays=32, num_radar_scans=2, max_radar_gt=16)


@pytest.fixture(scope="module")
def scene():
    out = t_synthetic.SyntheticDataParser(t_synthetic.SyntheticDataParserConfig(**SCENE)).get_dataparser_outputs()
    out.radar_fov = dict(RADAR_FOV)
    return out


def _config(max_steps: int = 11) -> TrainerConfig:
    cfg = TrainerConfig(max_num_iterations=max_steps, seed=5,
                        pipeline=t_pipeline.ADNeuRadarPipelineConfig(datamanager=t_dm.ADDataManagerConfig(**DM)),
                        optimizers=t_opt.default_optimizer_groups(max_steps))
    shrink(cfg.pipeline.model)
    cfg.pipeline.model.loss.vgg_mult = 0.0  # 12-pixel patches are too small for VGG-19's four pools
    return cfg


@pytest.fixture(scope="module")
def pipeline(scene):
    return t_pipeline.ADNeuRadarPipeline(_config().pipeline, scene, "cpu", seed=1)


def _window():
    snap = trace.snapshot()
    return len(snap.spans), dict(snap.counters)


def test_recorded_only_under_a_profiler_or_recording(pipeline):
    """(a) Outside recording nothing is logged and no counter moves; inside
    ``torch.profiler.profile()`` and inside ``trace.recording()`` a request's spans are logged, in a
    window of their own; a thread started beside a profiler records nothing."""
    with trace.recording():
        trace.count("marker")
    before = _window()
    pipeline.render_radar(0)
    with trace.span("request/radar", unit=True):
        trace.count("host_syncs")
    assert _window() == before

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pipeline.render_radar(0)
        side = threading.Thread(target=lambda: pipeline.render_radar(1))
        side.start()
        side.join(timeout=60)
    assert not side.is_alive()
    snap = trace.snapshot()
    assert ("marker", None) not in snap.counters  # a new window
    (request,) = snap.units("request/radar")
    assert {s.thread for s in snap.spans} == {threading.get_ident()}
    assert {"hash_encode", "radar_decoder", "host_sync/hash_scalings"} <= {s.name for s in snap.spans}

    with trace.recording():
        pipeline.render_radar(0)
    snap = trace.snapshot()
    assert len(snap.units("request/radar")) == 1
    assert snap.count("host_syncs", snap.units("request/radar")) > 0


def _check_nesting(snap, unit_name, parents):
    """One unit ``unit_name`` holds every span; each span's parent is the innermost span open
    around it, named as ``parents`` says."""
    (unit,) = snap.units(unit_name)
    assert unit.parent is None
    by_id = {s.id: s for s in snap.spans}
    for s in snap.spans:
        assert s.unit == unit.unit, s.name
        if s is unit:
            continue
        p = by_id[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns and p.thread == s.thread, s.name
        between = [q for q in snap.spans if q is not s and q is not p and q.thread == s.thread
                   and p.start_ns <= q.start_ns <= s.start_ns and s.end_ns <= q.end_ns <= p.end_ns]
        assert not between, (s.name, p.name, [q.name for q in between])
        assert p.name in parents[s.name], (s.name, p.name)


def test_request_spans_nest_and_share_an_id(pipeline):
    """(b) Every span of a tiny ``render_radar`` and of a tiny ``render_pose`` has the right parent
    and carries its request's id."""
    with trace.recording():
        pipeline.render_radar(1)
    snap = trace.snapshot()
    _check_nesting(snap, "request/radar", {
        "proposal_sampling": {"request/radar"},
        "field": {"request/radar"}, "composite_sky": {"request/radar"}, "radar_decoder": {"request/radar"},
        "hash_encode": {"proposal_sampling", "field"}, "host_sync/hash_scalings": {"hash_encode"}})
    assert {"field", "radar_decoder", "hash_encode"} <= {s.name for s in snap.spans}

    c2w = pipeline.outputs.camera_to_worlds[0]
    with trace.recording():
        image = pipeline.render_pose(c2w, hw=(12, 18))
    assert image.shape == (12, 18, 3) and image.dtype == np.uint8
    snap = trace.snapshot()
    _check_nesting(snap, "request/camera", {
        "proposal_sampling": {"request/camera"}, "field": {"request/camera"}, "composite_sky": {"request/camera"},
        "rgb_decoder": {"request/camera"}, "host_sync/render_pose": {"request/camera"},
        "host_sync/pose_camera": {"request/camera"}, "host_sync/camera_types": {"request/camera"},
        "hash_encode": {"proposal_sampling", "field"}, "host_sync/hash_scalings": {"hash_encode"}})
    assert [s.name for s in snap.spans].count("host_sync/render_pose") == 1
    assert [s.name for s in snap.spans].count("rgb_decoder") == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("dims", [3, 4])
def test_scatter_span_keeps_the_table_gradient(dims, dtype, monkeypatch):
    """(c) The table gradient through ``_CornerGather`` equals autograd's through a plain
    ``table[idx]`` a corner bit for bit (a small table, so corners collide and the accumulation order
    counts), with one ``hash_encode/scatter`` span per encode, on the backward's thread."""
    enc = encodings.HashEncoding(num_levels=4, min_res=4, max_res=64, log2_hashmap_size=6, features_per_level=2,
                                 n_input_dims=dims, compute_dtype=None if dtype == torch.float32 else dtype)
    gen = torch.Generator().manual_seed(dims)
    with torch.no_grad():
        enc.hash_table.copy_(torch.rand(enc.hash_table.shape, generator=gen) * 2 - 1)
    positions = torch.rand((300, dims), generator=gen)
    weights = torch.randn((300, enc.get_out_dim()), generator=gen)

    def table_grad():
        enc.hash_table.grad = None
        (enc(positions) * weights).sum().backward()
        return enc.hash_table.grad.clone()

    with trace.recording():
        wrapped = table_grad()
    snap = trace.snapshot()
    scatters = [s for s in snap.spans if s.name == "hash_encode/scatter"]
    assert len(scatters) == 1
    assert all(s.device_ms is None for s in scatters)  # the event pair is the card's alone
    monkeypatch.setattr(encodings, "_gather_corners", lambda table, idxs: [table[i] for i in idxs])
    plain = table_grad()
    assert wrapped.dtype == plain.dtype == torch.float32
    assert torch.equal(wrapped, plain)
    assert int((wrapped != 0).sum()) > 0
    with torch.no_grad(), trace.recording():
        enc(positions)  # no gradient: the plain gather, no scatter span
    assert not [s for s in trace.snapshot().spans if s.name == "hash_encode/scatter"]


def test_train_step_spans_and_syncs(scene):
    """(d) A tiny train step under recording logs ``train/step`` with ``train/next_batch`` (the
    wait on the prefetch queue) and ``host_sync/seed32`` inside it, and ``host_syncs`` counts one
    per ``host_sync/*`` span; every span carries the step's id."""
    trainer = Trainer(_config(), scene, "cpu")
    trainer.setup(prefetch=True)
    try:
        trainer.train_step()
        with trace.recording():
            trainer.train_step()
    finally:
        trainer.shutdown()
    snap = trace.snapshot()
    (step,) = snap.units("train/step")
    names = [s.name for s in snap.spans]
    assert {"train/next_batch", "host_sync/seed32", "train/forward", "train/optimizer", "hash_encode/scatter",
            "hash_encode"} <= set(names)
    by_id = {s.id: s for s in snap.spans}
    for name in ("train/next_batch", "train/forward", "train/optimizer"):
        (s,) = [s for s in snap.spans if s.name == name]
        assert by_id[s.parent] is step
    assert all(s.unit == step.unit for s in snap.spans)
    syncs = [s for s in snap.spans if s.name.startswith("host_sync/")]
    assert snap.count("host_syncs", [step]) == len(syncs) > 0
    assert snap.count("host_syncs", []) == 0


def test_no_scalings_or_scan_id_syncs(pipeline, scene):
    """(f) A tiny ``render_radar`` of one scan and of a batch, and a tiny train step, open no
    ``host_sync/feature_scalings`` (the level scalings are a buffer of the encoding) and no
    ``host_sync/scan_ids`` (the ids are copied from pinned memory on the card)."""
    trainer = Trainer(_config(), scene, "cpu")
    trainer.setup(prefetch=False)
    with trace.recording():
        pipeline.render_radar(1)
        pipeline.render_radar([0, 2])
        trainer.train_step()
        names = {s.name for s in trace.snapshot().spans}
    assert {"request/radar", "train/step", "hash_encode"} <= names
    assert not names & {"host_sync/feature_scalings", "host_sync/scan_ids"}


def test_tally_keeps_counts_out_of_the_window():
    """(g) Inside ``trace.tally()`` a thread's counts go to the tally, recording or not, and the window
    keeps none of them; nested tallies each keep their own."""
    with trace.recording():
        trace.count("launches/composite_sky_fwd")
        with trace.tally() as outer:
            build.check(0, "composite_sky_fwd")
            with trace.tally() as inner:
                trace.count("launches/hash_encode_fwd", 3)
            trace.count("host_syncs")
        snap = trace.snapshot()
    assert outer == {"launches/composite_sky_fwd": 1, "host_syncs": 1} and inner == {"launches/hash_encode_fwd": 3}
    assert snap.counters == {("launches/composite_sky_fwd", None): 1}
    with trace.tally() as off:
        trace.count("cuda_graph/captures")
    assert off == {"cuda_graph/captures": 1}


def test_launches_are_counted_by_build_check():
    """(e) ``build.check`` counts a successful launch as ``launches/<symbol>`` in the current window,
    once; a failed launch raises and counts nothing; outside a recording window nothing is counted."""
    with trace.recording():
        build.check(0, "composite_sky_fwd")
        with pytest.raises(RuntimeError, match="composite_sky_fwd.*cudaError_t 2"):
            build.check(2, "composite_sky_fwd")
    snap = trace.snapshot()
    assert snap.total("launches/composite_sky_fwd") == 1
    assert snap.counters == {("launches/composite_sky_fwd", None): 1}
    build.check(0, "composite_sky_fwd")
    assert trace.snapshot().counters == snap.counters
