"""The radar request as CUDA graphs (``pipelines/ad_neuradar_pipeline.render_radar``).

On the CPU: the feature rescale's level scalings, made once a module, equal the tensor every encode
used to copy to the device bit for bit; and the graph path's bookkeeping (the static scan ids, the
output's clone, the staleness guard, the counters, the lock) runs with a stand-in for a CUDA graph
whose replay reruns the captured function and writes the capture's outputs, as a graph's replay
rewrites its static outputs.

On the card (``cuda``; no JAX is imported, so they run on a machine without it):
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_radar_graphs.py
the replay is bit-equal to the eager path (the pipeline's ``_radar_eager``: its ``_radar_tokens`` and the
model's ``decode_radar``) on the presets at full width: every scan of the 24-scan synthetic scene at ZOD's
radar FoV (3,531 rays, one nff chunk) in two seeded orders, a batch of scans, the set decoder, and
``neuradar-vod``'s 4,400-ray scan in 8 nff chunks; outputs do not alias, an in-place change to a hash
table shows in the next replay, a replaced parameter is captured again, two threads get their own
scans, and the counters match the requests.
"""

import contextlib
import dataclasses
import threading

import numpy as np
import pytest
import torch

from neuradar_tpu_torch.cameras.radars import VOD_RADAR_FOV
from neuradar_tpu_torch.configs.method_configs import get_method
from neuradar_tpu_torch.data import datamanager as t_dm
from neuradar_tpu_torch.data.dataparsers import synthetic as t_synthetic
from neuradar_tpu_torch.field_components import neurad_encoding
from neuradar_tpu_torch.field_components.encodings import HashEncoding
from neuradar_tpu_torch.model_components.dynamic_actors import ActorEdits
from neuradar_tpu_torch.pipelines import ad_neuradar_pipeline as t_pipeline
from neuradar_tpu_torch.utils import trace

# the tiny scene and model of tests/test_torch_slice.py (which imports JAX)
SCENE = dict(num_frames=8, image_height=24, image_width=36, lidar_points_per_scan=256)
RADAR_FOV = dict(min_azimuth=-0.8, max_azimuth=0.8, min_elevation=-0.08, max_elevation=0.32,
                 azimuth_step=0.1, elevation_step=0.1)
DM = dict(num_rgb_patches=2, patch_size=4, num_lidar_rays=32, num_radar_scans=2, max_radar_gt=16)


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


class _ReplayedFunction:
    """A CUDA graph's stand-in on the CPU: ``replay`` reruns the captured function and writes its
    outputs into the capture's outputs; the counts the rerun makes are dropped, as a replay's are."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        with trace.tally():
            for static, new in zip(_flat(self.out), _flat(self.fn())):
                static.copy_(new)


class _CpuStream:
    def wait_stream(self, other):
        pass


def _capture_on_cpu(fn, pool, stream):
    with trace.tally() as counts:
        out = fn()
    trace.count("cuda_graph/captures")
    return _ReplayedFunction(fn, out), out, {k: n for k, n in counts.items() if k.startswith("launches/")}


@pytest.fixture
def cpu_graphs(monkeypatch):
    monkeypatch.setattr(t_pipeline, "_capture", _capture_on_cpu)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _CpuStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: _CpuStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())


def _shrink(m):
    """tests/test_torch_slice.shrink's tiny sizes, with no VGG loss."""
    m.field.grid.static.log2_hashmap_size = 12
    m.field.grid.actor.log2_hashmap_size = 10
    for pf in (m.sampling.proposal_field_1, m.sampling.proposal_field_2):
        pf.grid.static.log2_hashmap_size = 11
        pf.grid.actor.log2_hashmap_size = 9
    m.sampling.num_proposal_samples = (16, 8)
    m.sampling.num_nerf_samples = 6
    m.loss.vgg_mult = 0.0


def _tiny_pipeline(seed=3):
    out = t_synthetic.SyntheticDataParser(t_synthetic.SyntheticDataParserConfig(**SCENE)).get_dataparser_outputs()
    out.radar_fov = dict(RADAR_FOV)
    cfg = t_pipeline.ADNeuRadarPipelineConfig(datamanager=t_dm.ADDataManagerConfig(**DM))
    _shrink(cfg.model)
    pipe = t_pipeline.ADNeuRadarPipeline(cfg, out, "cpu", seed=seed)
    _perturb_tables(pipe, seed)
    return pipe


def _perturb_tables(pipe, seed):
    """Hash tables at U(-0.1, 0.1): at init (1e-3) every scan renders nearly alike."""
    gen = torch.Generator(device=pipe.device).manual_seed(seed)
    with torch.no_grad():
        for m in pipe.model.modules():
            if isinstance(m, HashEncoding):
                m.hash_table.uniform_(-0.1, 0.1, generator=gen)


@torch.inference_mode()
def _eager(pipe, scans):
    """The eager path of ``render_radar``, whose functions the graphs capture: [n_scans, n_mb, 7]."""
    return pipe._radar_eager(pipe._scan_ids(scans), pipe._radar_layout(len(scans)))


@torch.inference_mode()
def _replay(pipe, scans):
    return pipe._replay_radar(scans)


# ---------------------------------------------------------------------------- on the CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("preset", ["neuradar", "neurad", "neuradar-vod"])
def test_feature_scalings_equal_the_copied_tensor(preset, dtype):
    """Each grid's cached level scalings, cast to ``dtype`` as the rescale casts them, equal
    ``torch.tensor(scalings, dtype=dtype)``, the tensor each rescale copied to the device before, bit
    for bit; and they move with the module."""
    m = get_method(preset).pipeline.model
    grids = [m.field.grid] + [pf.grid for pf in (m.sampling.proposal_field_1, m.sampling.proposal_field_2)]
    for cfg in grids:
        for s in (cfg.static, cfg.actor):
            scalings = HashEncoding(num_levels=s.num_levels, min_res=s.base_res, max_res=s.max_res,
                                    log2_hashmap_size=4, features_per_level=s.hashgrid_dim).scalings
            cached = neurad_encoding.feature_scalings(scalings)
            old = torch.tensor(scalings, dtype=dtype)
            assert torch.equal(cached.to(dtype).view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                               old.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)), (preset, scalings)
    enc = neurad_encoding.NeuRADHashEncoding(neurad_encoding.NeuRADHashEncodingConfig(), 10.0, n_actors=2)
    assert {"static_scalings", "actor_scalings"} <= dict(enc.named_buffers()).keys()
    assert not {"static_scalings", "actor_scalings"} & enc.state_dict().keys()  # not part of a checkpoint
    assert enc.to(torch.device("meta")).static_scalings.device.type == "meta"


def test_replay_equals_the_eager_path(cpu_graphs):
    """With the stand-in graphs: one scan, then another through the same capture, then a batch of
    three under its own key; each equal to the eager path; consecutive outputs do not share storage;
    two captures a key, two replays a request."""
    pipe = _tiny_pipeline()
    with trace.recording():
        outs = [_replay(pipe, [s]) for s in (0, 5, 2)]
        batch = _replay(pipe, [1, 6, 3])
        snap = trace.snapshot()
    for s, out in zip((0, 5, 2), outs):
        assert torch.equal(out, _eager(pipe, [s]))
    assert torch.equal(batch, _eager(pipe, [1, 6, 3]))
    assert not torch.equal(outs[0], outs[1])
    assert len({o.data_ptr() for o in outs}) == 3
    rays, decoder = pipe.tables.radars.rays_per_scan, type(pipe.model.radar_decoder)
    assert set(pipe._radar_graphs) == {(1, rays, decoder), (3, rays, decoder)}
    assert snap.total("cuda_graph/captures") == 4 and snap.total("cuda_graph/replays") == 8
    assert snap.total("cuda_graph/eager") == 0


def test_replaced_tensor_is_captured_again(cpu_graphs):
    """An in-place change to a hash table keeps the capture; a replaced parameter, swapped radar
    tables or a replaced submodule are captured again; each replay equals the eager path at its time."""
    pipe = _tiny_pipeline()
    grid = pipe.model.field.hashgrid.static_grid
    with trace.recording():
        first = _replay(pipe, [4])
        with torch.no_grad():
            grid.hash_table.mul_(0.5)
        in_place = _replay(pipe, [4])
        assert torch.equal(in_place, _eager(pipe, [4])) and not torch.equal(in_place, first)
        assert trace.snapshot().total("cuda_graph/captures") == 2
        grid.hash_table = torch.nn.Parameter(grid.hash_table.detach() * 2.0)
        replaced = _replay(pipe, [4])
        assert torch.equal(replaced, _eager(pipe, [4])) and not torch.equal(in_place, replaced)
        assert trace.snapshot().total("cuda_graph/captures") == 4
        radars = pipe.tables.radars
        pipe.tables.radars = dataclasses.replace(radars, radar_to_worlds=radars.radar_to_worlds.roll(1, dims=0))
        swapped = _replay(pipe, [4])
        assert torch.equal(swapped, _eager(pipe, [4])) and not torch.equal(swapped, replaced)
        assert trace.snapshot().total("cuda_graph/captures") == 6
        old = pipe.model.appearance_embedding
        pipe.model.appearance_embedding = torch.nn.Embedding(old.num_embeddings, old.embedding_dim)
        with torch.no_grad():
            pipe.model.appearance_embedding.weight.copy_(old.weight * 3.0)
        new_module = _replay(pipe, [4])
        assert torch.equal(new_module, _eager(pipe, [4])) and not torch.equal(new_module, swapped)
        assert trace.snapshot().total("cuda_graph/captures") == 8


def test_actor_edits_and_cpu_take_the_eager_path():
    """``render_radar`` on the CPU, and with actor edits, runs the eager path: on the CPU it counts no
    ``cuda_graph/*`` at all, and opens ``radar_decoder`` once."""
    pipe = _tiny_pipeline()
    with trace.recording():
        out = pipe.render_radar(2)["radar_output"]
        edited = pipe.render_radar(2, actor_edits=ActorEdits(remove=True))["radar_output"]
        snap = trace.snapshot()
    assert torch.equal(out, _eager(pipe, [2])[0]) and edited.shape == out.shape
    assert not [k for k, _ in snap.counters if k.startswith("cuda_graph/")]
    assert [s.name for s in snap.spans].count("radar_decoder") == 2


# ---------------------------------------------------------------------------- on the card


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _preset_pipeline(device, preset, radar_fov=None, seed=7):
    """The preset's pipeline at full width on the synthetic scene (24 frames, 24 radar scans; ZOD's
    radar FoV unless ``radar_fov``), hash tables at U(-0.1, 0.1)."""
    out = t_synthetic.SyntheticDataParser(t_synthetic.SyntheticDataParserConfig()).get_dataparser_outputs()
    if radar_fov is not None:
        out.radar_fov = dict(radar_fov)
    pipe = t_pipeline.ADNeuRadarPipeline(get_method(preset).pipeline, out, device, seed=seed)
    _perturb_tables(pipe, seed)
    return pipe


@pytest.fixture(scope="module")
def zod(cuda):
    pipe = _preset_pipeline(cuda, "neuradar")
    assert pipe.tables.radars.rays_per_scan == 3531 and len(pipe.outputs.radar_to_worlds) == 24
    yield pipe
    del pipe
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_card_replay_is_bit_equal_on_every_scan(zod):
    """Every one of the 24 scans in two seeded orders: the replay equals the eager path bit for bit
    (``torch.equal``), through one capture."""
    eager = {s: _eager(zod, [s]) for s in range(24)}
    with trace.recording():
        for seed in (11, 2**31 + 5):
            for s in np.random.RandomState(seed % 2**32).permutation(24):
                got = zod.render_radar(int(s))["radar_output"]
                assert got.shape == (3531, 7)
                assert torch.equal(got, eager[int(s)][0]), int(s)
        snap = trace.snapshot()
    assert snap.total("cuda_graph/captures") <= 2 and snap.total("cuda_graph/replays") == 96


@pytest.mark.cuda
def test_card_batch_and_aliasing(zod):
    """A batch of four scans under its own capture equals the eager batch; consecutive outputs of one
    key do not share storage, and an earlier output keeps its values after later replays."""
    batch = zod.render_radar([3, 17, 0, 9])["radar_output"]
    assert torch.equal(batch, _eager(zod, [3, 17, 0, 9]))
    first = zod.render_radar(5)["radar_output"]
    kept = first.clone()
    second = zod.render_radar(6)["radar_output"]
    assert first.data_ptr() != second.data_ptr()
    assert torch.equal(first, kept) and not torch.equal(first, second)


@pytest.mark.cuda
def test_card_in_place_change_and_replaced_parameter(zod):
    """An in-place change to a hash table shows in the next replay with no new capture; a replaced
    parameter is captured again and read."""
    grid = zod.model.field.hashgrid.static_grid
    zod.render_radar(8)
    saved = grid.hash_table.detach().clone()
    try:
        with trace.recording():
            with torch.no_grad():
                grid.hash_table.mul_(0.5)
            in_place = zod.render_radar(8)["radar_output"]
            captures = trace.snapshot().total("cuda_graph/captures")
        assert captures == 0 and torch.equal(in_place, _eager(zod, [8])[0])
        grid.hash_table = torch.nn.Parameter(saved * 1.5)
        with trace.recording():
            replaced = zod.render_radar(8)["radar_output"]
            captures = trace.snapshot().total("cuda_graph/captures")
        assert captures == 2 and torch.equal(replaced, _eager(zod, [8])[0])
        assert not torch.equal(in_place, replaced)
    finally:
        grid.hash_table = torch.nn.Parameter(saved)
        zod.render_radar(8)


@pytest.mark.cuda
def test_card_two_threads_get_their_scans(zod):
    """Two threads render at once, each its own scans, 12 requests each: every output is its scan's."""
    eager = {s: _eager(zod, [s])[0] for s in range(24)}
    wrong, errors = [], []

    def client(scans):
        try:
            for s in scans:
                if not torch.equal(zod.render_radar(s)["radar_output"], eager[s]):
                    wrong.append(s)
        except Exception as e:  # reported below: a thread's exception is otherwise lost
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(list(range(i, 24, 2)),)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not wrong, (errors, wrong)


@pytest.mark.cuda
def test_card_counters_match_the_requests(zod):
    """k requests of a captured shape: ``cuda_graph/replays`` 2k, no capture, and each
    ``launches/<symbol>`` k times the eager path's; a request with actor edits counts
    ``cuda_graph/eager`` and launches what the eager path does."""
    zod.render_radar(1)
    with trace.recording():
        zod.render_radar(1, actor_edits=ActorEdits())
        snap = trace.snapshot()
    eager = {k: snap.total(k) for k, _ in snap.counters if k.startswith("launches/")}
    assert snap.total("cuda_graph/eager") == 1 and eager.get("launches/hash_encode_fwd", 0) == 6
    assert {"launches/composite_sky_fwd", "launches/self_attention_bf16_fwd"} <= eager.keys()
    with trace.recording():
        for s in (1, 2, 3, 4, 5):
            zod.render_radar(s)
        snap = trace.snapshot()
    launches = {k: snap.total(k) for k, _ in snap.counters if k.startswith("launches/")}
    assert launches == {k: 5 * n for k, n in eager.items()}
    assert snap.total("cuda_graph/replays") == 10 and snap.total("cuda_graph/captures") == 0
    assert snap.total("cuda_graph/eager") == 0 and snap.total("host_syncs") == 0
    requests = snap.units("request/radar")
    assert len(requests) == 5 and snap.count("cuda_graph/replays", requests) == 10
    decoder = [s for s in snap.spans if s.name == "radar_decoder"]
    assert len(decoder) == 5 and all(s.parent in {r.id for r in requests} for s in decoder)


@pytest.mark.cuda
@pytest.mark.parametrize("preset, radar_fov, rays", [("neuradar-set", None, 3531), ("neuradar-vod", VOD_RADAR_FOV, 4400)],
                         ids=["set", "vod"])
def test_card_other_presets_are_bit_equal(cuda, preset, radar_fov, rays):
    """The set decoder (300 queries) and ``neuradar-vod``'s 4,400-ray scan in 8 nff chunks: single scans
    and a batch of two, bit-equal to the eager path."""
    pipe = _preset_pipeline(cuda, preset, radar_fov)
    assert pipe.tables.radars.rays_per_scan == rays
    n_mb = 300 if preset == "neuradar-set" else rays
    for s in (0, 13, 7):
        got = pipe.render_radar(s)["radar_output"]
        assert got.shape == (n_mb, 7) and torch.equal(got, _eager(pipe, [s])[0]), s
    assert torch.equal(pipe.render_radar([2, 21])["radar_output"], _eager(pipe, [2, 21]))
    del pipe
    torch.cuda.empty_cache()
