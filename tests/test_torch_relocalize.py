"""The port's relocalization (`rgbd_odometry_tpu_torch.pipeline.relocalize`
and its hooks in `EdgeDvoOdometry`) on the scenes of tests/test_relocalize.py
at 160x120: the database unit (recovered global pose within 15 mm, a blank
query gives None, attempt and success counts) against the JAX `Relocalizer`
with JAX's random draws replayed (same keyframe, inliers, pose within 1e-4),
a JAX database loaded through `convert.load_store`, the refresh after an
online refinement, and the blackout-teleport run with and without
relocalization."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from rgbd_odometry_tpu.config import (  # noqa: E402
    CameraConfig,
    KeyframeConfig,
    PipelineConfig,
    PyramidConfig,
    RelocalizeConfig,
    SolverConfig,
)
from rgbd_odometry_tpu.core.camera import Intrinsics as JaxIntrinsics  # noqa: E402
from rgbd_odometry_tpu.io.synthetic import render_sequence  # noqa: E402
from rgbd_odometry_tpu.pipeline.relocalize import Relocalizer as JaxRelocalizer  # noqa: E402
from rgbd_odometry_tpu_torch import convert  # noqa: E402
from rgbd_odometry_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.gop import REASON_RELOCALIZED, Gop  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.odometry import EdgeDvoOdometry  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.relocalize import Relocalizer  # noqa: E402

torch.set_num_threads(2)
CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
RELOC = RelocalizeConfig(enabled=True, trigger_consecutive=1, min_matches=20, min_inliers=12)
BLANK = (np.zeros((120, 160), np.float32), np.zeros((120, 160), np.float32))


class JaxDraws:
    """The JAX matcher's draws, in its order: per RANSAC call
    `key, ek = split(key)`, then `uniform(k_i, (K,))` for k_i in
    `split(ek, S)`. Installed as a port matcher's `_uniforms`."""

    def __init__(self, seed: int = 0):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, s: int, k: int) -> torch.Tensor:
        self.key, ek = jax.random.split(self.key)
        u = jax.vmap(lambda kk: jax.random.uniform(kk, (k,)))(jax.random.split(ek, s))
        return torch.from_numpy(np.array(u))


def _smooth_psis(n, step=0.004):
    ts = np.arange(n)
    return np.stack([0.8 * step * ts, -0.5 * step * ts, 0.3 * step * ts,
                     0.15 * step * ts, -0.2 * step * ts, 0.1 * step * ts], -1).astype(np.float32)


@pytest.fixture(scope="module")
def seq():
    return render_sequence(CAM, _smooth_psis(8), seed=0)


def _database(cls, intr, frames, poses, **kw):
    reloc = cls(intr, RELOC, **kw)
    for k in (0, 3, 6):
        assert reloc.add_keyframe(*frames[k], *poses[k], node=k)
    return reloc


def test_relocalizer_unit_matches_jax(seq):
    frames, poses = seq
    jr = _database(JaxRelocalizer, JaxIntrinsics.from_config(CAM), frames, poses)
    pr = _database(Relocalizer, Intrinsics.from_config(CAM), frames, poses, device="cpu")
    pr.matcher._uniforms = JaxDraws(0)
    assert len(pr) == len(jr) == 3
    want, got = jr.relocalize(frames[4][0]), pr.relocalize(frames[4][0])
    assert got is not None and want is not None
    assert (got.keyframe, got.num_inliers) == (want.keyframe, want.num_inliers)
    assert got.num_inliers >= RELOC.min_inliers
    np.testing.assert_allclose(got.R, want.R, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.t, want.t, rtol=0, atol=1e-4)
    err_mm = 1000 * np.linalg.norm(got.t - poses[4][1])
    assert err_mm < 15.0, err_mm
    np.testing.assert_allclose(got.R @ got.R.T, np.eye(3), atol=1e-3)
    assert pr.relocalize(BLANK[0]) is None
    assert pr.attempts == 2 and pr.successes == 1


def test_own_generator_recovers_and_evicts_nearest(seq):
    frames, poses = seq
    pr = _database(Relocalizer, Intrinsics.from_config(CAM), frames, poses, device="cpu")
    res = pr.relocalize(frames[4][0])
    assert res is not None and 1000 * np.linalg.norm(res.t - poses[4][1]) < 15.0
    # frames without keypoints or depth never enter the database
    assert not pr.add_keyframe(*BLANK, *poses[0])
    assert not pr.add_keyframe(frames[1][0], BLANK[1], *poses[1])
    # at max_keyframes the entry nearest to the incoming pose is replaced
    capped = Relocalizer(Intrinsics.from_config(CAM), dataclasses.replace(RELOC, max_keyframes=3),
                         device="cpu")
    for k in (0, 3, 6, 4):
        assert capped.add_keyframe(*frames[k], *poses[k], node=k)
    assert len(capped) == 3 and capped.nodes == [0, 4, 6]
    assert capped.matcher.num_slots() == RELOC.slot_capacity


def test_loaded_jax_database_recovers_like_jax(seq):
    frames, poses = seq
    jr = _database(JaxRelocalizer, JaxIntrinsics.from_config(CAM), frames, poses)
    pr = Relocalizer(Intrinsics.from_config(CAM), RELOC, device="cpu")
    convert.load_store(jr, pr)
    assert pr.nodes == [0, 3, 6] and len(pr) == 3
    pr.matcher._uniforms = JaxDraws(0)
    want, got = jr.relocalize(frames[5][0]), pr.relocalize(frames[5][0])
    assert (got.keyframe, got.num_inliers) == (want.keyframe, want.num_inliers)
    np.testing.assert_allclose(got.t, want.t, rtol=0, atol=1e-4)


def test_database_poses_refresh_after_online_refinement(seq):
    frames, poses = seq
    reloc = Relocalizer(Intrinsics.from_config(CAM), RELOC, device="cpu")
    gop = Gop()
    gop.push_keyframe(0, 1, np.eye(3), np.zeros(3))
    for k in (3, 6):
        gop.push_keyframe_absolute(k, 5, *poses[k])
    for slot, k in enumerate((0, 3, 6)):
        assert reloc.add_keyframe(*frames[k], *gop.global_pose(slot), node=slot)
    R_all, t_all, _ = gop.poses()
    delta = np.array([0.05, -0.02, 0.01])
    gop.set_poses(R_all, t_all + delta)
    assert reloc.update_poses(gop) == 3
    for slot in range(3):
        np.testing.assert_allclose(reloc.poses[slot][1], t_all[slot] + delta, atol=1e-12)
    res = reloc.relocalize(frames[4][0])
    assert res is not None and 1000 * np.linalg.norm(res.t - (poses[4][1] + delta)) < 15.0


def _blackout_teleport_run(enabled: bool):
    """6 fast tracked frames, 3 blank frames, then 4 slow frames teleported
    back near the origin (tests/test_relocalize.py)."""
    frames_a, _ = render_sequence(CAM, _smooth_psis(6, step=0.012), seed=0)
    frames_b, poses_b = render_sequence(CAM, _smooth_psis(4, step=0.002), seed=0)
    cfg = PipelineConfig(
        camera=CAM,
        pyramid=PyramidConfig(num_levels=3, max_points=(2048, 1024, 512)),
        solver=SolverConfig(method="gauss_newton", iterations=(50, 8, 5)),
        keyframe=KeyframeConfig(force_every=5, enable_quality_triggers=True,
                                rollback_resolve=True),
        relocalize=dataclasses.replace(RELOC, enabled=enabled),
    )
    odo = EdgeDvoOdometry(cfg, device="cpu")
    for i, (g, d) in enumerate(list(frames_a) + [BLANK] * 3 + list(frames_b)):
        odo.process_frame(g, d, timestamp=float(i))
    _, t_est, _ = odo.trajectory()
    gt_b = np.stack([p[1] for p in poses_b])
    return odo, 1000 * np.linalg.norm(t_est[-3:] - gt_b[-3:], axis=1)


@pytest.mark.parametrize("enabled", [True, False])
def test_blackout_teleport(enabled):
    odo, err_mm = _blackout_teleport_run(enabled)
    reasons = [e.reason for e in odo.gop.elements]
    if enabled:
        assert REASON_RELOCALIZED in reasons, reasons
        assert odo._reloc.successes >= 1
        assert err_mm.max() < 25.0, err_mm
        # only healthy textured keyframes entered the database
        assert 2 <= len(odo._reloc) <= 12
    else:
        assert odo._reloc is None and REASON_RELOCALIZED not in reasons
        assert err_mm.min() > 30.0, err_mm
