"""The port's own copies of the JAX package's jax-free modules stay equal to
the originals: the configuration dataclasses and profiles field for field
(`dataclasses.asdict`), and `eval.ate`, `io.calib`, `io.synthetic`'s scene
and degradations, `viz.pointcloud`, `viz.colormap`, `viz.overlay` and the
`io.xml_dump` helpers output for output on a few inputs."""

import dataclasses
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from rgbd_odometry_tpu import config as jax_config  # noqa: E402
from rgbd_odometry_tpu import profiles as jax_profiles  # noqa: E402
from rgbd_odometry_tpu.eval import ate as jax_ate  # noqa: E402
from rgbd_odometry_tpu.io import calib as jax_calib  # noqa: E402
from rgbd_odometry_tpu.io import synthetic as jax_synthetic  # noqa: E402
from rgbd_odometry_tpu.io import xml_dump as jax_xml_dump  # noqa: E402
from rgbd_odometry_tpu.viz import colormap as jax_colormap  # noqa: E402
from rgbd_odometry_tpu.viz import overlay as jax_overlay  # noqa: E402
from rgbd_odometry_tpu.viz import pointcloud as jax_pointcloud  # noqa: E402
from rgbd_odometry_tpu_torch import config, profiles  # noqa: E402
from rgbd_odometry_tpu_torch.eval import ate  # noqa: E402
from rgbd_odometry_tpu_torch.io import calib, synthetic, xml_dump  # noqa: E402
from rgbd_odometry_tpu_torch.viz import colormap, overlay, pointcloud  # noqa: E402

_CONFIGS = ("CameraConfig", "PyramidConfig", "SolverConfig", "PhotometricConfig",
            "KeyframeConfig", "RelocalizeConfig", "PipelineConfig")


@pytest.mark.parametrize("name", _CONFIGS)
def test_config_dataclasses_match_field_for_field(name):
    mine, theirs = getattr(config, name), getattr(jax_config, name)
    assert [(f.name, f.type) for f in dataclasses.fields(mine)] == [
        (f.name, f.type) for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(mine()) == dataclasses.asdict(theirs())


def test_pipeline_config_json_round_trip_across_packages():
    cfg = config.PipelineConfig(solver=config.SolverConfig(iterations=(7, 5, 3, 2)),
                                motion_model="constant_velocity")
    back = jax_config.PipelineConfig.from_json(cfg.to_json())
    assert dataclasses.asdict(back) == dataclasses.asdict(cfg)
    assert config.PipelineConfig.from_json(back.to_json()) == cfg


@pytest.mark.parametrize("name", ("parity_320", "production_320", "production_vga"))
def test_profiles_match_field_for_field(name):
    mine, theirs = getattr(profiles, name)(), getattr(jax_profiles, name)()
    assert mine.name == theirs.name and mine.max_points == theirs.max_points
    assert mine.num_levels == theirs.num_levels
    assert dataclasses.asdict(mine.camera) == dataclasses.asdict(theirs.camera)
    assert dataclasses.asdict(mine.solver) == dataclasses.asdict(theirs.solver)


def _trajectory(rng, n):
    from scipy.spatial.transform import Rotation

    R = Rotation.from_rotvec(rng.normal(0, 0.2, (n, 3))).as_matrix()
    return R, np.cumsum(rng.normal(0, 0.05, (n, 3)), axis=0)


def test_ate_copy_matches():
    rng = np.random.default_rng(5)
    R_e, t_e = _trajectory(rng, 40)
    R_g, t_g = R_e @ _trajectory(rng, 1)[0][0], t_e + rng.normal(0, 0.01, t_e.shape)
    for align in (True, False):
        assert ate.ate_rmse(t_e, t_g, align) == jax_ate.ate_rmse(t_e, t_g, align)
    assert ate.rpe(R_e, t_e, R_g, t_g, 3) == jax_ate.rpe(R_e, t_e, R_g, t_g, 3)
    assert dataclasses.asdict(ate.drift_stats(t_e, t_g)) == dataclasses.asdict(
        jax_ate.drift_stats(t_e, t_g))
    for a, b in zip(ate.rebase_to_first(R_e, t_e), jax_ate.rebase_to_first(R_e, t_e)):
        np.testing.assert_array_equal(a, b)
    ts_e = np.arange(40) / 30.0
    ts_g = np.arange(0, 40 / 30.0, 0.01) + 0.003
    R_g2, t_g2 = _trajectory(rng, len(ts_g))
    mine = ate.associate_trajectories(R_e, t_e, ts_e, R_g2, t_g2, ts_g)
    theirs = jax_ate.associate_trajectories(R_e, t_e, ts_e, R_g2, t_g2, ts_g)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)


def test_calib_copy_matches(tmp_path):
    cam = config.CameraConfig(width=640, height=480, fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                              distortion=(0.26, -0.95, -0.005, 0.002, 1.16))
    mine, theirs = str(tmp_path / "mine_640x480.xml"), str(tmp_path / "theirs_640x480.xml")
    calib.write_calib_xml(mine, cam)
    jax_calib.write_calib_xml(theirs, jax_config.CameraConfig(**dataclasses.asdict(cam)))
    with open(mine) as a, open(theirs) as b:
        assert a.read() == b.read()
    assert dataclasses.asdict(calib.read_calib_xml(theirs)) == dataclasses.asdict(
        jax_calib.read_calib_xml(mine))
    (tmp_path / "m").mkdir()
    (tmp_path / "j").mkdir()
    pair_m = calib.write_freiburg_pair(str(tmp_path / "m"), cam)
    pair_j = jax_calib.write_freiburg_pair(str(tmp_path / "j"), cam)
    for a, b in zip(pair_m, pair_j):
        assert dataclasses.asdict(calib.read_calib_xml(a)) == dataclasses.asdict(
            jax_calib.read_calib_xml(b))


def test_synthetic_scene_and_degradations_copy_match():
    cam = config.CameraConfig().scaled(0.25)
    deg = dict(texture_amp=8.0, noise_sigma=2.0, depth_noise_mm=3.0, illum_gain_per_frame=0.01,
               depth_quantize_tum=True, depth_shadow_px=2, depth_dropout_blobs=2,
               motion_blur_px=3.0)
    R = np.array([[0.999, -0.04, 0.0], [0.04, 0.999, 0.0], [0.0, 0.0, 1.0]])
    t = np.array([0.02, -0.01, 0.03])
    mine = synthetic.SyntheticScene(seed=4, texture_amp=8.0).render(cam, R, t, 2)
    theirs = jax_synthetic.SyntheticScene(seed=4, texture_amp=8.0).render(cam, R, t, 2)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    for i in (0, 3):
        a = synthetic.degrade_frame(*mine, i, synthetic.Degradations(**deg))
        b = jax_synthetic.degrade_frame(*theirs, i, jax_synthetic.Degradations(**deg))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert dataclasses.asdict(synthetic.Degradations()) == dataclasses.asdict(
        jax_synthetic.Degradations())


def test_pointcloud_copy_matches(tmp_path):
    rng = np.random.default_rng(2)
    gray = rng.uniform(0, 255, (24, 32)).astype(np.float32)
    depth = rng.uniform(50, 3000, (24, 32)).astype(np.float32)
    R, t = _trajectory(rng, 3)
    args = (gray, depth, 40.0, 40.0, 15.5, 11.5, R[1], t[1], 2)
    for a, b in zip(pointcloud.frame_to_cloud(*args), jax_pointcloud.frame_to_cloud(*args)):
        np.testing.assert_array_equal(a, b)
    clouds = [(pointcloud.frame_to_cloud(gray, depth, 40.0, 40.0, 15.5, 11.5)[0], i)
              for i in (0, 2)]
    for a, b in zip(pointcloud.compose_map(clouds, R, t), jax_pointcloud.compose_map(clouds, R, t)):
        np.testing.assert_array_equal(a, b)
    pts = pointcloud.compose_map(clouds, R, t)[0]
    pointcloud.write_ply(str(tmp_path / "a.ply"), pts)
    jax_pointcloud.write_ply(str(tmp_path / "b.ply"), pts)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()


def test_colormap_and_overlay_copies_match():
    rng = np.random.default_rng(3)
    v = rng.uniform(-1, 9, (7, 9))
    assert np.array_equal(colormap.apply_colormap(v, n=16), jax_colormap.apply_colormap(v, n=16))
    assert overlay.REASON_COLORS == jax_overlay.REASON_COLORS
    gray = rng.uniform(0, 255, (10, 12))
    uv = rng.uniform(0, 12, (30, 2))
    r = rng.uniform(0, 5, 30)
    for name, args in (("overlay_points", (gray, uv)), ("residue_heatmap", (gray, uv, r)),
                       ("energy_plot", (r, 3, 40, 60)), ("trajectory_plot", (np.c_[r, r, r],)),
                       ("residual_histogram_plot", (r, 1.5, 30, 40)),
                       ("reprojected_depth_map", (gray, uv, r))):
        a, b = getattr(overlay, name)(*args), getattr(jax_overlay, name)(*args)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_xml_dump_helpers_copy_match(tmp_path):
    rng = np.random.default_rng(4)
    gray = [rng.uniform(0, 255, (8 >> k, 10 >> k)) for k in range(4)]
    depth = [rng.uniform(0, 5000, (8 >> k, 10 >> k)) for k in range(4)]
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    pa = xml_dump.write_frame_dump(str(tmp_path / "a"), 12, gray, depth)
    pb = jax_xml_dump.write_frame_dump(str(tmp_path / "b"), 12, gray, depth)
    assert open(pa, "rb").read() == open(pb, "rb").read()
    assert xml_dump.frame_path("x", 12) == jax_xml_dump.frame_path("x", 12)
    assert [os.path.basename(p) for _, p in xml_dump.list_dump_frames(str(tmp_path / "a"))] == [
        os.path.basename(p) for _, p in jax_xml_dump.list_dump_frames(str(tmp_path / "b"))]
    for a, b in zip(xml_dump.read_frame_dump(pa), jax_xml_dump.read_frame_dump(pb)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
