"""The port's ZOD parser and the shared dataparser steps against the JAX package's.

base.py's recenter_poses, scene_box_from_poses, synthesize_missing_points and zero_base_times on
numpy inputs from a seed (the port keeps them in numpy, so they agree exactly); then the ZOD parser
on a copy of the stand-in devkit of tests/test_dataset_parsers.py (no dataset or devkit is on this
machine): the JAX parser and the port's read the same mocked sequence, and every field of their
outputs must agree exactly.
"""

import sys
import types
from dataclasses import dataclass, fields

import numpy as np
import pytest

from neuradar_tpu.data.dataparsers import base as jb
from neuradar_tpu.data.dataparsers import zod as jz
from neuradar_tpu_torch.data.dataparsers import base as tb
from neuradar_tpu_torch.data.dataparsers import zod as tz


def _poses(rng, n):
    p = np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1))
    p[:, :3, :3] += rng.normal(0, 0.05, (n, 3, 3)).astype(np.float32)
    p[:, :3, 3] = rng.normal(0, 20, (n, 3)).astype(np.float32)
    return p


def test_recenter_and_scene_box():
    rng = np.random.RandomState(0)
    sets = [_poses(rng, 5), None, np.zeros((0, 3, 4), np.float32), _poses(rng, 3)]
    (got, got_c), (want, want_c) = tb.recenter_poses(sets), jb.recenter_poses(sets)
    np.testing.assert_array_equal(got_c, want_c)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(sets[0][:, :3, 3], _poses(np.random.RandomState(0), 5)[:, :3, 3])  # not in place
    for padding in (40.0, 2.5):
        np.testing.assert_array_equal(tb.scene_box_from_poses(got, padding).aabb,
                                      jb.scene_box_from_poses(want, padding).aabb)


@pytest.mark.parametrize("skip", [(), (2,)])
def test_synthesize_missing_points(skip):
    """A scan of 4 channels, one too sparse to fill (under 32 returns), one skipped in the second
    case: the synthesized far points, their times and channels."""
    rng = np.random.RandomState(1)
    n_per = [400, 250, 20, 300]
    pts = []
    for ch, n in enumerate(n_per):
        az = rng.uniform(-np.pi, np.pi * 0.3, n)
        el = np.full(n, -0.1 + 0.05 * ch) + rng.normal(0, 1e-3, n)
        d = rng.uniform(5, 60, n)
        pts.append(np.stack([d * np.cos(el) * np.cos(az), d * np.cos(el) * np.sin(az), d * np.sin(el),
                             rng.uniform(0, 1, n), rng.uniform(-0.05, 0.05, n), np.full(n, ch)], 1))
    pts = np.concatenate(pts).astype(np.float32)
    got = tb.synthesize_missing_points(pts, azimuth_resolution_deg=0.5, skip_channels=skip)
    want = jb.synthesize_missing_points(pts, azimuth_resolution_deg=0.5, skip_channels=skip)
    assert got.dtype == want.dtype and len(got) > len(pts)
    np.testing.assert_array_equal(got, want)
    assert tb.synthesize_missing_points(pts[:0]).shape == (0, 6)


def test_zero_base_times():
    rng = np.random.RandomState(2)
    sets = [rng.uniform(100, 110, 7), rng.uniform(99, 111, 5), np.zeros(0), None]
    trajs = [dict(timestamps=rng.uniform(100, 110, 4)) for _ in range(2)]
    t_trajs = [dict(t) for t in trajs]
    (got, got_d), (want, want_d) = tb.zero_base_times(sets, t_trajs), jb.zero_base_times(sets, trajs)
    assert got_d == want_d
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
    for g, w in zip(t_trajs, trajs):
        np.testing.assert_array_equal(g["timestamps"], w["timestamps"])


# ------------------------------------------------------------ the stand-in devkit (a copy)


class _TS:
    def __init__(self, t):
        self._t = t

    def timestamp(self):
        return self._t


class _CamFrame:
    def __init__(self, t, img):
        self.time = _TS(t)
        self._img = img

    def read(self):
        return self._img


class _LidarData:
    def __init__(self, rng, t, n, channels):
        self.points = rng.randn(n, 3).astype(np.float64) * 10
        self.timestamps = np.full(n, t) + rng.rand(n) * 0.05
        self.intensity = rng.randint(0, 255, n).astype(np.float64)
        self.diode_idx = rng.randint(0, channels, n)


class _LidarFrame:
    def __init__(self, rng, t, n, channels):
        self._data = _LidarData(rng, t, n, channels)

    def read(self):
        return self._data


class _Extr:
    def __init__(self, transform):
        self.transform = transform


class _CamCalib:
    def __init__(self):
        self.extrinsics = _Extr(np.eye(4))
        self.intrinsics = np.array([[120.0, 0, 16], [0, 121.0, 400], [0, 0, 1]])
        self.distortion = np.array([0.1, -0.05, 0.001, -0.002])


@dataclass
class _Obj:  # a devkit-shaped (dataclass) annotation
    name: str
    uuid: str
    pose: np.ndarray
    size: list


class _Seq:
    def __init__(self, dense_lidar):
        rng = np.random.RandomState(0)
        h = 756  # HOOD_HEIGHT = 750 leaves 6 rows
        self._cam_frames = [_CamFrame(100.0 + i, rng.randint(0, 255, (h, 32, 3), np.uint8)) for i in range(4)]
        # a dense scan (few channels, many returns) gives synthesize_missing_points work to do
        n, channels = (600, 3) if dense_lidar else (64, 128)
        self._lidar_frames = [_LidarFrame(rng, 100.0 + i + 0.5, n, channels) for i in range(3)]
        consts = sys.modules["zod.constants"]
        rot = np.eye(4)
        rot[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
        cam_calib = _CamCalib()
        cam_calib.extrinsics = _Extr(rot @ np.diag([1.0, 1.0, 1.0, 1.0]))
        self.calibration = types.SimpleNamespace(
            cameras={consts.Camera.FRONT: cam_calib},
            lidars={consts.Lidar.VELODYNE: types.SimpleNamespace(extrinsics=_Extr(np.eye(4)))},
            radars={consts.Radar.FRONT: types.SimpleNamespace(extrinsics=_Extr(rot))},
        )
        self.info = types.SimpleNamespace(
            get_camera_frames=lambda anonymization=None: self._cam_frames,
            get_lidar_frames=lambda: self._lidar_frames,
        )
        self.ego_motion = types.SimpleNamespace(get_poses=self._pose)

    @staticmethod
    def _pose(t):
        p = np.eye(4)
        p[0, 3] = float(np.median(t)) - 100.0  # the ego drives +x at 1 m/s
        return p

    def get_annotation(self, name):
        def pose(x, y):
            p = np.eye(4)
            p[:3, :3] = [[0.8, -0.6, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.0]]
            p[:3, 3] = [x, y, 0.0]
            return p

        frames = []
        for i in range(3):
            objs = [{"name": "Vehicle", "uuid": "actor-1", "pose": pose(5.0 + i, 1.0), "size": [4.5, 2.0, 1.6]},
                    _Obj("Pedestrian", "ped-1", pose(8.0, -2.0 + 0.3 * i), [0.6, 0.7, 1.8]),
                    {"name": "TrafficSign", "uuid": "sign-1", "pose": pose(9.0, 3.0), "size": [0.1, 0.5, 0.5]}]
            if i > 0:
                objs.append(_Obj("Bicyclist", "bike-1", pose(12.0 - i, 4.0), [1.8, 0.6, 1.7]))
            frames.append({"timestamp": 100.0 + i + (0.25 if i == 2 else 0.0), "objects": objs[::-1]})
        return frames


@pytest.fixture()
def stand_in_zod(monkeypatch, tmp_path):
    """The stand-in devkit in sys.modules and a sequence's radar file: 2 scans of qualities 0..4."""
    consts = types.ModuleType("zod.constants")
    consts.Anonymization = types.SimpleNamespace(BLUR="blur")
    consts.Camera = types.SimpleNamespace(FRONT="front")
    consts.Lidar = types.SimpleNamespace(VELODYNE="velodyne")
    consts.Radar = types.SimpleNamespace(FRONT="front")
    zod_mod = types.ModuleType("zod")

    class ZodSequences:
        dense_lidar = False

        def __init__(self, dataset_root, version):
            self._root = dataset_root

        def __getitem__(self, seq_id):
            return _Seq(ZodSequences.dense_lidar)

    zod_mod.ZodSequences = ZodSequences
    monkeypatch.setitem(sys.modules, "zod", zod_mod)
    monkeypatch.setitem(sys.modules, "zod.constants", consts)
    rd = tmp_path / "sequences" / "000581" / "radar_front"
    rd.mkdir(parents=True)
    rows = [[t, 10.0 + q, q * 0.5, 0.3, 20.0, -1.0, 0, q] for t in (100.2, 101.2) for q in range(5)]
    np.save(rd / "radar.npy", np.asarray(rows))
    return tmp_path, ZodSequences


def _assert_same_outputs(got, want):
    for f in fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name in ("camera_split", "lidar_split", "radar_split"):
            np.testing.assert_array_equal(g.train, w.train, err_msg=f.name)
            np.testing.assert_array_equal(g.eval, w.eval, err_msg=f.name)
        elif f.name == "scene_box":
            np.testing.assert_array_equal(g.aabb, w.aabb)
        elif f.name in ("lidar_points", "radar_points"):
            assert len(g) == len(w), f.name
            for a, b in zip(g, w):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif f.name == "trajectories":
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert sorted(a) == sorted(b)
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"trajectory {k}")
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name


@pytest.mark.parametrize("missing", [False, True])
def test_zod_parser_matches_jax(stand_in_zod, missing):
    """Every field of the outputs, with and without the synthesized non-return lidar points: the hood
    crop, the fisheye type and its padded distortion, the lidar packing and ego filter, the radar
    quality filter, the actors (the allowed and deformable categories, poses turned from w-l-h to
    l-w-h, sizes reordered), zero-based times, the recentred poses, the scene box, the splits and the
    lane-shift sign."""
    root, devkit = stand_in_zod
    devkit.dense_lidar = missing
    kw = dict(sequence="000581", data=str(root), add_missing_points=missing)
    got = tz.ZodDataParserConfig(**kw).setup().get_dataparser_outputs()
    want = jz.ZodDataParserConfig(**kw).setup().get_dataparser_outputs()
    _assert_same_outputs(got, want)
    assert got.images.shape == (4, 6, 32, 3) and got.camera_type[0] == int(tz.CameraType.FISHEYE)
    assert [len(p) for p in got.radar_points] == [3, 3]
    assert sorted((t["symmetric"], t["deformable"]) for t in got.trajectories) == [
        (False, True), (True, False), (True, False)]
    if missing:
        assert sum(len(p) for p in got.lidar_points) > 3 * 600  # far points were added


def test_zod_config_matches_jax():
    got, want = tz.ZodDataParserConfig(), jz.ZodDataParserConfig()
    assert [f.name for f in fields(got)] == [f.name for f in fields(want)]
    for f in fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    for name in ("OPENCV_TO_NERF", "WLH_TO_LWH"):
        np.testing.assert_array_equal(getattr(tz, name), getattr(jz, name))
    assert tz.ZOD_RADAR_FOV == jz.ZOD_RADAR_FOV and tz.ZOD_LANE_SHIFT_SIGN == jz.ZOD_LANE_SHIFT_SIGN
    assert (tz.HOOD_HEIGHT, tz.ALLOWED_CATEGORIES, tz.DEFORMABLE_CATEGORIES) == (
        jz.HOOD_HEIGHT, jz.ALLOWED_CATEGORIES, jz.DEFORMABLE_CATEGORIES)


def test_zod_parser_without_devkit(monkeypatch):
    """Without the devkit both parsers raise the same ImportError."""
    monkeypatch.setitem(sys.modules, "zod", None)
    messages = []
    for mod in (tz, jz):
        with pytest.raises(ImportError) as err:
            mod.ZodDataParserConfig().setup().get_dataparser_outputs()
        messages.append(str(err.value))
    assert messages[0] == messages[1] and "pip install zod" in messages[0]
