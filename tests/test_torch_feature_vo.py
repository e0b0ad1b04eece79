"""The port's sparse feature VO (`rgbd_odometry_tpu_torch/pipeline/feature_vo.py`)
against the JAX package's `FeatureVo` on the CPU, on the 160x120 camera of the
JAX tests. The port draws its RANSAC uniforms from a `torch.Generator`; here
JAX's threefry draws are replayed through `FeatureVo._uniforms`, so both run
the same hypotheses."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from rgbd_odometry_tpu.config import CameraConfig as JaxCamera  # noqa: E402
from rgbd_odometry_tpu.io.synthetic import render_sequence  # noqa: E402
from rgbd_odometry_tpu.pipeline.feature_vo import FeatureVo as JaxFeatureVo  # noqa: E402
from rgbd_odometry_tpu.pipeline.feature_vo import FeatureVoConfig as JaxFeatureVoConfig  # noqa: E402
from rgbd_odometry_tpu_torch.config import CameraConfig  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.feature_vo import FeatureVo, FeatureVoConfig  # noqa: E402

JCAM = JaxCamera(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)


class JaxDraws:
    """JAX's draws in its order: per RANSAC call `key, sub = split(key)`,
    then `uniform(k_i, (K,))` for k_i in `split(sub, S)`."""

    def __init__(self, seed: int = 0):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, s: int, k: int) -> torch.Tensor:
        self.key, sub = jax.random.split(self.key)
        u = jax.vmap(lambda kk: jax.random.uniform(kk, (k,)))(jax.random.split(sub, s))
        return torch.from_numpy(np.array(u))


@pytest.fixture(scope="module")
def frames():
    ts = np.arange(5)
    psis = np.stack([0.004 * ts, -0.003 * ts, 0.002 * ts, 0.001 * ts, -0.001 * ts, 0.0005 * ts],
                    -1).astype(np.float32)
    return render_sequence(JCAM, psis, seed=0)


def _run(vo, frames):
    for i, (g, d) in enumerate(frames):
        vo.process_frame(g, d, float(i))
    return vo.trajectory()


CONFIGS = {
    "jax_test": dict(max_keypoints=256, min_good_matches=8),
    "no_epipolar": dict(max_keypoints=256, min_good_matches=8, epipolar_filter=False),
    "starved": dict(max_keypoints=128, min_good_matches=1000),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_feature_vo_matches_jax_with_replayed_draws(frames, name):
    """JAX's `test_feature_vo_tracks` scenario (and without the epipolar
    gate, and starved so that every frame switches keyframe): the good-match
    counts and keyframes equal JAX's, the poses within 1e-4 of JAX's, and
    the final position within JAX's 0.1 m of the ground truth."""
    seq, poses = frames
    cfg = CONFIGS[name]
    jvo = JaxFeatureVo(JCAM, JaxFeatureVoConfig(**cfg))
    R_j, t_j, _ = _run(jvo, seq)
    vo = FeatureVo(CAM, FeatureVoConfig(**cfg), device="cpu")
    vo._uniforms = JaxDraws(0)
    R_p, t_p, ts = _run(vo, seq)
    assert vo.match_counts == jvo.match_counts
    assert vo.gop.keyframe_indices() == jvo.gop.keyframe_indices()
    np.testing.assert_allclose(R_p, R_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_p, t_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts, np.arange(5.0))
    gt_t = np.stack([p[1] for p in poses])
    assert np.linalg.norm(t_p[-1] - gt_t[-1]) < 0.1


def test_feature_vo_tracks_with_its_own_draws(frames):
    """With the port's own generator (seeded draws, not JAX's), the JAX
    test's bar: the final position within 0.1 m of the ground truth; the
    same seed gives the same trajectory twice."""
    seq, poses = frames
    runs = [_run(FeatureVo(CAM, FeatureVoConfig(max_keypoints=256, min_good_matches=8), seed=3,
                           device="cpu"), seq) for _ in range(2)]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    gt_t = np.stack([p[1] for p in poses])
    assert np.linalg.norm(runs[0][1] - gt_t, axis=-1)[-1] < 0.1


def test_feature_vo_command_loses_the_track_where_jax_does(tmp_path, monkeypatch, capsys):
    """`feature-vo --frames 30` at the command's defaults (320x240,
    --min-matches 40) in both packages, JAX's draws replayed: the same
    good-match counts a frame and the same keyframes. JAX's FeatureVo loses
    this synthetic track (every frame through 15 within its
    `test_feature_vo_tracks` bar of 0.1 m, frame 16 metres off, NaN from
    frame 25) and the port loses it at the same frames; before the loss the
    trajectories agree within 1e-4. chip_smoke.py holds the card's run to
    these counts and this loss frame (FEATURE_VO_COUNTS,
    FEATURE_VO_LOST_FROM)."""
    import chip_smoke
    import rgbd_odometry_tpu.pipeline.feature_vo as jfv
    from rgbd_odometry_tpu.cli import main as jax_main
    from rgbd_odometry_tpu_torch.cli import main
    from rgbd_odometry_tpu_torch.io.tum import read_trajectory

    made = {}

    def recording(cls, key):
        init = cls.__post_init__

        def post(self):
            init(self)
            made[key] = self

        monkeypatch.setattr(cls, "__post_init__", post)

    recording(jfv.FeatureVo, "jax")
    recording(FeatureVo, "port")
    draws = JaxDraws(0)
    monkeypatch.setattr(FeatureVo, "_uniforms", lambda self, s, k: draws(s, k))
    jax_main(["feature-vo", "--frames", "30", "--out", str(tmp_path / "j.txt")])
    got = main(["feature-vo", "--frames", "30", "--out", str(tmp_path / "p.txt"),
                "--device", "cpu"])
    err = capsys.readouterr().err
    assert err.count("good matches") == 60
    jvo, pvo = made["jax"], made["port"]
    assert pvo.match_counts == jvo.match_counts == list(chip_smoke.FEATURE_VO_COUNTS)
    assert pvo.gop.keyframe_indices() == jvo.gop.keyframe_indices()
    _, t_j, _ = read_trajectory(str(tmp_path / "j.txt"))
    _, t_p, _ = read_trajectory(str(tmp_path / "p.txt"))
    assert t_j.shape == t_p.shape == (30, 3)
    gt_t = got["gt"][1][:30]
    e_j, e_p = (np.linalg.norm(t - gt_t, axis=-1) for t in (t_j, t_p))

    def first(bad):
        return int(np.nonzero(bad)[0][0]) if bad.any() else None

    lost = chip_smoke.FEATURE_VO_LOST_FROM
    assert first(~(e_j < 0.1)) == first(~(e_p < 0.1)) == lost
    assert first(~np.isfinite(e_j)) == first(~np.isfinite(e_p)) == 25
    np.testing.assert_allclose(t_p[:lost], t_j[:lost], rtol=0, atol=1e-4)
