"""The port's real-data parsers against the JAX package's: VoD, nuScenes, PandaSet, KITTI MOT,
Argoverse 2 and WOD.

No dataset or devkit is on this machine. Each parser pair reads the same stand-in on disk: the
files and mocked devkits of tests/test_dataset_parsers.py (its fixtures imported, its two inline
trees copied below), and every field of their DataparserOutputs must agree exactly (the parsers are
numpy on both sides). The configs' fields and defaults, and the parsers' module constants, must
equal the JAX package's.
"""

import json
import sys
from dataclasses import fields

import numpy as np
import pytest

from neuradar_tpu.data.dataparsers import argoverse2 as j_av2
from neuradar_tpu.data.dataparsers import kittimot as j_kitti
from neuradar_tpu.data.dataparsers import nuscenes as j_nusc
from neuradar_tpu.data.dataparsers import pandaset as j_panda
from neuradar_tpu.data.dataparsers import vod as j_vod
from neuradar_tpu.data.dataparsers import wod as j_wod
from neuradar_tpu_torch.cameras.radars import VOD_RADAR_FOV, fov_grid
from neuradar_tpu_torch.data.dataparsers import argoverse2 as t_av2
from neuradar_tpu_torch.data.dataparsers import kittimot as t_kitti
from neuradar_tpu_torch.data.dataparsers import nuscenes as t_nusc
from neuradar_tpu_torch.data.dataparsers import pandaset as t_panda
from neuradar_tpu_torch.data.dataparsers import vod as t_vod
from neuradar_tpu_torch.data.dataparsers import wod as t_wod
from tests.test_dataset_parsers import _write_vod_tree, mock_av2, mock_nuscenes, mock_wod  # noqa: F401 (fixtures)
from tests.test_torch_zod import _assert_same_outputs


def _both(j_mod, t_mod, config_name, **kw):
    """(port outputs, JAX outputs) of the same config."""
    return (getattr(t_mod, config_name)(**kw).setup().get_dataparser_outputs(),
            getattr(j_mod, config_name)(**kw).setup().get_dataparser_outputs())


def _write_vod_radar_calibs(root):
    """The radar split's calibs: frame 0 a radar -> camera extrinsic of its own, frame 1 a calib without
    the line (the lidar's pose is kept), frame 4 none; frame 3's pose is missing (the frame is skipped)."""
    calib = root / "radar" / "training" / "calib"
    calib.mkdir(parents=True)
    c, s = np.cos(0.1), np.sin(0.1)
    tr = np.array([[c, -s, 0.0, 0.3], [s, c, 0.0, -0.1], [0.0, 0.0, 1.0, 0.05]])
    (calib / "00000.txt").write_text("P2: 1 0 0 0 0 1 0 0 0 0 1 0\nTr_velo_to_cam: "
                                     + " ".join(map(str, tr.reshape(-1))))
    (calib / "00001.txt").write_text("P2: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    for fi in (2, 3):
        (calib / f"{fi:05d}.txt").write_text("Tr_velo_to_cam: " + " ".join(map(str, np.eye(3, 4).reshape(-1))))
    (root / "lidar" / "training" / "pose" / "00003.json").unlink()


def test_vod_parser_matches_jax(tmp_path):
    """The odometry-chained poses (camera, lidar through Tr_velo_to_cam, radar through the radar
    calib or the lidar's pose), the radar GT's x, y, z, the images, times, the recentred world and
    the splits, with a frame skipped and the radar calib's three cases; VoD's FoV gives 4,400 rays."""
    _write_vod_tree(tmp_path, n_frames=6)
    _write_vod_radar_calibs(tmp_path)
    got, want = _both(j_vod, t_vod, "VodDataParserConfig", sequence="00", data=str(tmp_path))
    _assert_same_outputs(got, want)
    assert len(got.camera_to_worlds) == 5 and got.radar_points[0].shape == (8, 3)
    assert not np.allclose(got.radar_to_worlds[0], got.lidar_to_worlds[0])  # its own extrinsic
    np.testing.assert_array_equal(got.radar_to_worlds[1], got.lidar_to_worlds[1])  # the fallback
    assert len(fov_grid(**VOD_RADAR_FOV)) == 4400


def _write_kittimot_tree(tmp_path, seq="0006"):
    """tests/test_dataset_parsers.py::test_kittimot_parser's tree with a yaw in the oxts poses and a
    second Pedestrian: 4 frames (one a row taller), a calib with a translation, a Car track over 3
    frames, a DontCare, a one-frame Pedestrian and a two-frame one."""
    import PIL.Image

    root = tmp_path / "training"
    for sub in (f"image_02/{seq}", f"velodyne/{seq}", "calib", "oxts", "label_02"):
        (root / sub).mkdir(parents=True)
    P2 = np.zeros((3, 4))
    P2[0, 0], P2[1, 1], P2[0, 2], P2[1, 2] = 720.0, 721.0, 60.0, 18.0
    Tr = np.hstack([np.eye(3), np.array([[0.1], [0.0], [-0.05]])])
    (root / "calib" / f"{seq}.txt").write_text(
        "P2: " + " ".join(map(str, P2.reshape(-1))) + "\n" + "Tr_velo_cam " + " ".join(map(str, Tr.reshape(-1))) + "\n")
    oxts = [f"{49.0 + i * 1e-5} 8.43 112.8 0.0 0.0 {0.01 * i} " + " ".join(["0"] * 24) for i in range(4)]
    (root / "oxts" / f"{seq}.txt").write_text("\n".join(oxts))
    rng = np.random.RandomState(0)
    for i in range(4):
        PIL.Image.fromarray(rng.randint(0, 255, (36 + (i % 2), 120, 3), np.uint8)).save(
            root / "image_02" / seq / f"{i:06d}.png")
        rng.randn(64, 4).astype(np.float32).tofile(root / "velodyne" / seq / f"{i:06d}.bin")
    lines = [f"{fr} 1 Car 0 0 0 0 0 0 0 1.5 1.7 4.0 {2.0 + fr} 1.0 8.0 0.3" for fr in range(3)]
    lines += ["0 2 DontCare 0 0 0 0 0 0 0 1 1 1 0 0 0 0", "1 3 Pedestrian 0 0 0 0 0 0 0 1.8 0.6 0.6 1 1 5 0",
              "2 4 Pedestrian 0 0 0 0 0 0 0 1.8 0.6 0.6 1 1 5 0.2",
              "3 4 Pedestrian 0 0 0 0 0 0 0 1.8 0.6 0.6 1.2 1 5 0.2"]
    (root / "label_02" / f"{seq}.txt").write_text("\n".join(lines))


def test_kittimot_parser_matches_jax(tmp_path):
    """The oxts poses (Mercator, relative to the first), the camera through the inverse calib, the
    images cropped to the smallest, the tracks chained object -> camera -> velodyne -> world."""
    _write_kittimot_tree(tmp_path)
    got, want = _both(j_kitti, t_kitti, "KittiMotDataParserConfig", sequence="0006", data=str(tmp_path))
    _assert_same_outputs(got, want)
    assert got.images.shape == (4, 36, 120, 3)
    assert [(t["symmetric"], t["deformable"]) for t in got.trajectories] == [(True, False), (False, True)]


def _write_pandaset_tree(tmp_path):
    """tests/test_dataset_parsers.py::test_pandaset_parser's sequence, with a turning heading: 4 camera
    frames and lidar frames (world points with i, t, d), a Car cuboid in every frame and a Cones one."""
    import pandas as pd
    import PIL.Image

    seq = tmp_path / "001"
    cam, lid, cub = seq / "camera" / "front_camera", seq / "lidar", seq / "annotations" / "cuboids"
    for d in (cam, lid, cub):
        d.mkdir(parents=True)

    def pose_dict(x, yaw):
        return {"position": {"x": x, "y": 0.1 * x, "z": 1.5},
                "heading": {"w": np.cos(yaw / 2), "x": 0.0, "y": 0.0, "z": np.sin(yaw / 2)}}

    n = 4
    rng = np.random.RandomState(0)
    (cam / "poses.json").write_text(json.dumps([pose_dict(i * 2.0, 0.05 * i) for i in range(n)]))
    (cam / "intrinsics.json").write_text(json.dumps({"fx": 400.0, "fy": 401.0, "cx": 20.0, "cy": 14.0}))
    (cam / "timestamps.json").write_text(json.dumps([100.0 + 0.1 * i for i in range(n)]))
    (lid / "poses.json").write_text(json.dumps([pose_dict(i * 2.0, 0.05 * i) for i in range(n)]))
    (lid / "timestamps.json").write_text(json.dumps([100.05 + 0.1 * i for i in range(n)]))
    for i in range(n):
        PIL.Image.fromarray(rng.randint(0, 255, (28, 40, 3), np.uint8)).save(cam / f"{i:02d}.jpg")
        pts = rng.randn(32, 3) * 10
        pd.DataFrame({"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2], "i": rng.randint(0, 255, 32).astype(float),
                      "t": 100.05 + 0.1 * i + rng.rand(32) * 0.02, "d": rng.randint(0, 64, 32).astype(float),
                      }).to_pickle(lid / f"{i:02d}.pkl.gz")
        pd.DataFrame({"uuid": ["c1", "px"], "label": ["Car", "Cones"], "yaw": [0.3, 0.0],
                      "position.x": [5.0 + i, 0.0], "position.y": [1.0, 0.0], "position.z": [0.5, 0.0],
                      "dimensions.x": [2.0, 1.0], "dimensions.y": [4.5, 1.0], "dimensions.z": [1.6, 1.0],
                      }).to_pickle(cub / f"{i:02d}.pkl.gz")


def test_pandaset_parser_matches_jax(tmp_path):
    """The top-to-bottom rolling shutter (velocities from the pose differences, the offsets), the
    lidar points moved into the sensor frame with intensity, time and laser, the cuboid actors."""
    _write_pandaset_tree(tmp_path)
    got, want = _both(j_panda, t_panda, "PandasetDataParserConfig", sequence="001", data=str(tmp_path))
    _assert_same_outputs(got, want)
    assert got.camera_velocities is not None and len(got.trajectories) == 1


def test_nuscenes_parser_matches_jax(mock_nuscenes):
    """The samples chained by 'next', ego @ calibration poses, the sweep's packing, the car's
    trajectory turned w-l-h -> l-w-h."""
    got, want = _both(j_nusc, t_nusc, "NuScenesDataParserConfig", sequence="scene-0103", data=str(mock_nuscenes))
    _assert_same_outputs(got, want)
    assert got.masks is None and len(got.trajectories) == 1


def test_nuscenes_masks_match_jax(mock_nuscenes, monkeypatch):
    """With mask_dir: a mask png where there is one (above 127 keeps a pixel), all kept where not."""
    import PIL.Image

    mask_dir = mock_nuscenes / "maskroot"
    (mask_dir / "masks" / "CAM_FRONT").mkdir(parents=True)
    keep = np.random.RandomState(4).randint(0, 256, (20, 30)).astype(np.uint8)
    PIL.Image.fromarray(keep).save(mask_dir / "masks" / "CAM_FRONT" / "cam_1.png")
    # the devkit's camera sample_data names its image file; the stand-in's records carry no name
    nusc_cls = sys.modules["nuscenes.nuscenes"].NuScenes
    get = nusc_cls.get

    def get_with_filename(self, table, token):
        rec = get(self, table, token)
        if table == "sample_data" and token.startswith("csd"):
            rec = {**rec, "filename": f"samples/CAM_FRONT/cam_{token[3:]}.jpg"}
        return rec

    monkeypatch.setattr(nusc_cls, "get", get_with_filename)
    kw = dict(sequence="scene-0103", data=str(mock_nuscenes), mask_dir=str(mask_dir))
    got, want = _both(j_nusc, t_nusc, "NuScenesDataParserConfig", **kw)
    _assert_same_outputs(got, want)
    assert got.masks.shape == (3, 20, 30) and got.masks[[0, 2]].all()
    np.testing.assert_array_equal(got.masks[1], keep > 127)


def test_argoverse2_parser_matches_jax(mock_av2):
    """Nearest ego poses, the camera's extrinsic and intrinsics from the feathers, the lidar packing,
    the annotated tracks in (l, w, h)."""
    got, want = _both(j_av2, t_av2, "Argoverse2DataParserConfig", sequence="log-0001", data=str(mock_av2))
    _assert_same_outputs(got, want)
    assert len(got.trajectories) == 1


def test_wod_parser_matches_jax(mock_wod):
    """The horizontal rolling shutter (column readout, its offsets and flag), the camera's pose
    through WOD's axes, the range image's points with min-max intensity, the labels yawed -90 deg."""
    got, want = _both(j_wod, t_wod, "WodDataParserConfig", sequence="segment-000.tfrecord", data=str(mock_wod))
    _assert_same_outputs(got, want)
    assert bool(got.rolling_shutter_horizontal.all()) and len(got.trajectories) == 1


@pytest.mark.parametrize("j_mod,t_mod,config,constants", [
    (j_vod, t_vod, "VodDataParserConfig", ("VOD_SEQUENCES", "FRAME_RATE", "VOD_RADAR_FOV")),
    (j_nusc, t_nusc, "NuScenesDataParserConfig", ("ALLOWED_CATEGORIES", "DEFORMABLE_CATEGORIES")),
    (j_panda, t_panda, "PandasetDataParserConfig", ("ALLOWED_CATEGORIES", "DEFORMABLE_CATEGORIES",
                                                    "ROLLING_SHUTTER_DURATION")),
    (j_kitti, t_kitti, "KittiMotDataParserConfig", ("ALLOWED", "DEFORMABLE", "FRAME_RATE")),
    (j_av2, t_av2, "Argoverse2DataParserConfig", ("ALLOWED", "DEFORMABLE")),
    (j_wod, t_wod, "WodDataParserConfig", ("ALLOWED_TYPES", "DEFORMABLE_TYPES")),
])
def test_parser_config_matches_jax(j_mod, t_mod, config, constants):
    got, want = getattr(t_mod, config)(), getattr(j_mod, config)()
    assert [f.name for f in fields(got)] == [f.name for f in fields(want)]
    for f in fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    for name in constants:
        assert getattr(t_mod, name) == getattr(j_mod, name), name
