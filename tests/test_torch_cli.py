"""The port's command line (`python -m rgbd_odometry_tpu_torch.cli`) on the
CPU: `dvo` at the JAX CLI's defaults against the JAX `EdgeDvoOdometry` and
ground truth, `eval`, `--gt` files, a short sub-gradient run, the feeder, TUM replay
against the JAX `TumSource`, `--cam-scale 3`, the map backend (`--loop-close` in both
refine modes, online and information-weighted, `--map-out`, `--relocalize`, and `refine`
against the JAX CLI's JSON), `calib` and `probe` against the JAX commands, the
unported subcommands, and no JAX at import. `--checkpoint`/`--resume` are in
tests/test_torch_checkpoint.py, `--viz-dir` in test_torch_viz.py, `--trace-dir` in
test_torch_tracing.py, `dump` and `xml:` in test_torch_xml_dump.py."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from rgbd_odometry_tpu.config import CameraConfig, KeyframeConfig, PipelineConfig, SolverConfig  # noqa: E402
from rgbd_odometry_tpu.io.stream import TumSource as JaxTumSource  # noqa: E402
from rgbd_odometry_tpu.pipeline.odometry import EdgeDvoOdometry as JaxOdometry  # noqa: E402
from rgbd_odometry_tpu_torch.cli import main  # noqa: E402
from rgbd_odometry_tpu_torch.io.stream import SyntheticCamera, TumSource  # noqa: E402
from rgbd_odometry_tpu_torch.io.tum import read_trajectory  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_cli_dvo_defaults_match_jax_and_eval(tmp_path, capsys):
    """The JAX CLI test's command (tests/test_cli.py) on the port: the
    `dvo` defaults (standard LM, normalized DT, full EDT, the feeder)."""
    est = str(tmp_path / "est.txt")
    main(["dvo", "--device", "cpu", "--frames", "5", "--iterations", "12,5,3,2", "--out", est])
    out = capsys.readouterr()
    stats = _last_json(out.out)
    assert stats["ate_rmse"] < 0.02
    assert sum(line.startswith("frame ") for line in out.err.splitlines()) == 5
    R_p, t_p, ts_p = read_trajectory(est)
    assert t_p.shape == (5, 3)
    # the JAX driver on the same frames, configured as its CLI configures it
    cfg = PipelineConfig(camera=CameraConfig(), keyframe=KeyframeConfig(force_every=5),
                         solver=SolverConfig(method="gauss_newton", iterations=(12, 5, 3, 2)))
    jax_odo = JaxOdometry(cfg)
    for gray, depth, ts in SyntheticCamera(CameraConfig(), num_frames=5).frames():
        jax_odo.process_frame(gray, depth, ts)
    R_j, t_j, ts_j = jax_odo.trajectory()
    np.testing.assert_allclose(ts_p, ts_j, atol=1e-6)
    assert np.linalg.norm(t_p - t_j, axis=-1).max() < 1e-3
    assert np.abs(R_p - R_j).max() < 2e-3
    main(["eval", est, est])
    ev = _last_json(capsys.readouterr().out)
    assert ev["ate_rmse_raw"] == 0.0 and ev["frames"] == 5


def test_cli_dvo_subgradient_short(capsys):
    main(["dvo", "--device", "cpu", "--method", "subgradient", "--iterations", "20,10,10,10",
          "--frames", "3"])
    stats = _last_json(capsys.readouterr().out)
    assert stats["ate_rmse"] < 0.025


def test_cli_feeder_and_no_feeder_give_the_same_trajectory(tmp_path, capsys):
    paths = []
    for flag in ("--feeder", "--no-feeder"):
        paths.append(str(tmp_path / f"{flag}.txt"))
        main(["dvo", "--device", "cpu", "--cam-scale", "0.5", "--frames", "4",
              "--iterations", "12,5,3,2", flag, "--out", paths[-1]])
    capsys.readouterr()
    with open(paths[0]) as a, open(paths[1]) as b:
        assert a.read() == b.read()


def test_cli_gt_file_comparison(tmp_path, capsys):
    """`--gt`: the estimate is paired with a ground-truth file by nearest
    timestamp (within --gt-max-dt) and rebased, as the JAX CLI does."""
    from rgbd_odometry_tpu_torch.io.tum import write_trajectory

    cam = CameraConfig().scaled(0.5)
    R, t = SyntheticCamera(cam, num_frames=4).ground_truth()
    gt = str(tmp_path / "gt.txt")
    write_trajectory(gt, R, t, np.arange(4) / 30.0 + 0.005)
    main(["dvo", "--device", "cpu", "--cam-scale", "0.5", "--frames", "4",
          "--iterations", "12,5,3,2", "--gt", gt])
    lines = capsys.readouterr().out.strip().splitlines()
    vs_file, last = json.loads(lines[-2]), json.loads(lines[-1])
    assert vs_file["frames_compared"] == 4 and vs_file["ate_rmse_vs_gt_file"] < 0.02
    assert last["ate_rmse"] < 0.02
    main(["dvo", "--device", "cpu", "--cam-scale", "0.5", "--frames", "2",
          "--iterations", "2,1,1,1", "--gt", gt, "--gt-max-dt", "0.001"])
    assert "no est/GT pairs" in capsys.readouterr().out


def _write_tum_dir(root, n=3):
    """n rendered frames as a TUM directory: 640x480 8-bit PNGs and uint16
    depth at 5000 units per metre, with rgb.txt and depth.txt."""
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    cam = CameraConfig(width=640, height=480, fx=525.0, fy=525.0, cx=319.5, cy=239.5)
    rgb_lines, depth_lines = [], []
    for i, (gray, depth, _) in enumerate(SyntheticCamera(cam, num_frames=n).frames()):
        ts = 100.0 + i / 30.0
        cv2.imwrite(str(root / "rgb" / f"{i}.png"), np.clip(gray, 0, 255).astype(np.uint8))
        cv2.imwrite(str(root / "depth" / f"{i}.png"), (depth * 5.0).astype(np.uint16))
        rgb_lines.append(f"{ts:.6f} rgb/{i}.png")
        depth_lines.append(f"{ts + 0.004:.6f} depth/{i}.png")
    (root / "rgb.txt").write_text("# rgb\n" + "\n".join(rgb_lines) + "\n")
    (root / "depth.txt").write_text("# depth\n" + "\n".join(depth_lines) + "\n")


def test_tum_source_matches_jax_and_runs_through_the_cli(tmp_path, capsys):
    root = tmp_path / "seq"
    _write_tum_dir(root)
    port = list(TumSource(str(root), native=False).frames())
    want = list(JaxTumSource(str(root), native=False).frames())
    assert len(port) == len(want) == 3
    for (g, d, ts), (gj, dj, tsj) in zip(port, want):
        assert g.shape == (240, 320) and np.array_equal(g, gj) and np.array_equal(d, dj)
        assert ts == tsj
    est = str(tmp_path / "tum_est.txt")
    main(["dvo", "--device", "cpu", "--source", f"tum:{root}", "--iterations", "6,3,2,2",
          "--out", est])
    err = capsys.readouterr().err
    assert "frame    2" in err
    _, t, ts = read_trajectory(est)
    assert t.shape == (3, 3) and np.isfinite(t).all()
    np.testing.assert_allclose(ts, [100.0, 100.0 + 1 / 30.0, 100.0 + 2 / 30.0], atol=1e-6)


@pytest.mark.parametrize("cmd, item", [
    ("photometric", "item 8 'Secondary solvers'"), ("feature-vo", "item 8 'Secondary solvers'"),
    ("pnp", "item 8 'Secondary solvers'"), ("imu", "item 8 'Secondary solvers'"),
    ("fused", "item 8 'Secondary solvers'"), ("bench", "item 1 'H100 bench protocol'"),
])
def test_cli_unported_subcommands_exit_naming_their_roadmap_item(cmd, item):
    """The JAX subcommands not ported yet parse the JAX parser's flags, then
    exit naming their ROADMAP.md Queue 1 item by number and by name."""
    flags = {"photometric": ["--huber", "--frames", "2"], "feature-vo": ["--min-matches", "5"],
             "pnp": [], "imu": ["--steps", "3"], "fused": ["--imu-refine", "--no-imu"],
             "bench": ["--batch", "4"]}[cmd]
    with pytest.raises(SystemExit) as exc:
        main([cmd, *flags])
    assert "not ported to rgbd_odometry_tpu_torch" in str(exc.value)
    assert f"ROADMAP.md Queue 1, {item}" in str(exc.value)


def test_cli_calib_matches_jax(tmp_path, capsys):
    """`calib --write-freiburg` writes JAX's two files byte for byte and prints
    JAX's JSON; `calib --file` prints JAX's JSON for each."""
    from rgbd_odometry_tpu.cli import main as jax_main

    out = {}
    for name, fn in (("port", main), ("jax", jax_main)):
        d = tmp_path / name
        d.mkdir()
        fn(["calib", "--write-freiburg", str(d)])
        written = _last_json(capsys.readouterr().out)["written"]
        files = []
        for path in written:
            fn(["calib", "--file", path])
            files.append((os.path.basename(path), open(path, "rb").read(),
                          capsys.readouterr().out))
        out[name] = files
    assert out["port"] == out["jax"] and len(out["port"]) == 2


@pytest.mark.parametrize("method", ["gauss_newton", "subgradient"])
def test_cli_probe_matches_jax(method, capsys):
    """`probe --level 2 --iterations 12` on the CPU against the JAX command:
    the same JSON keys and level, the first energy within 1e-3 relative.
    Sub-gradient: every energy within 1e-3 relative (the float32 reduction
    order) and the same best iteration. Gauss-Newton: JAX samples the bf16
    DT channel through its one-hot gathers, whose rounding the port's
    sampler does not copy (tests/test_torch_level_lm.py holds the level
    with the sampler rounding like JAX's), so the steps part slightly:
    every energy within 2% and the lowest within 0.5%."""
    from rgbd_odometry_tpu.cli import main as jax_main

    argv = ["probe", "--level", "2", "--iterations", "12", "--method", method]
    got = main([*argv, "--device", "cpu"])
    port = _last_json(capsys.readouterr().out)
    jax_main(argv)
    want = _last_json(capsys.readouterr().out)
    assert port.keys() == want.keys() and port["level"] == want["level"] == 2
    assert len(port["energy"]) == len(want["energy"]) == 12 and len(got["energy_raw"]) == 12
    pe, je = np.asarray(port["energy"]), np.asarray(want["energy"])
    np.testing.assert_allclose(pe[0], je[0], rtol=1e-3)
    if method == "subgradient":
        np.testing.assert_allclose(pe, je, rtol=1e-3, atol=2e-3)
        assert port["best_iter"] == want["best_iter"]
        assert abs(port["best_energy"] - want["best_energy"]) <= 1e-3 * want["best_energy"] + 2e-3
    else:
        np.testing.assert_allclose(pe, je, rtol=2e-2)
        np.testing.assert_allclose(pe.min(), je.min(), rtol=5e-3)
    assert abs(port["visible_ratio"] - want["visible_ratio"]) <= 1e-3


def test_cli_cam_scale_3_matches_jax(tmp_path, capsys):
    """`dvo --cam-scale 3`: level 0 at 960x720, which the card's kernels
    take since the EDT's column phase and extraction fit it; on the CPU the
    plain versions, two frames against JAX's driver configured as its CLI
    configures it (test_cli_dvo_defaults_match_jax_and_eval's bars)."""
    est = str(tmp_path / "est.txt")
    main(["dvo", "--device", "cpu", "--cam-scale", "3", "--frames", "2", "--iterations",
          "3,2,2,2", "--no-feeder", "--out", est])
    assert _last_json(capsys.readouterr().out)["ate_rmse"] < 0.02
    cam = CameraConfig().scaled(3)
    assert (cam.width, cam.height) == (960, 720)
    cfg = PipelineConfig(camera=cam, keyframe=KeyframeConfig(force_every=5),
                         solver=SolverConfig(method="gauss_newton", iterations=(3, 2, 2, 2)))
    jax_odo = JaxOdometry(cfg)
    for gray, depth, ts in SyntheticCamera(cam, num_frames=2).frames():
        jax_odo.process_frame(gray, depth, ts)
    R_j, t_j, _ = jax_odo.trajectory()
    R_p, t_p, _ = read_trajectory(est)
    assert np.linalg.norm(t_p - t_j, axis=-1).max() < 1e-3
    assert np.abs(R_p - R_j).max() < 2e-3


def test_cli_pipelined_writes_the_sequential_trajectory(tmp_path, capsys):
    """`dvo --pipelined` (process_stream fed by the frame feeder) writes the
    same trajectory file, bit for bit, as the run without it."""
    argv = ["dvo", "--device", "cpu", "--cam-scale", "0.5", "--frames", "7", "--iterations",
            "6,3,2,2", "--keyframe-every", "3"]
    files = []
    for extra in ([], ["--pipelined"]):
        est = str(tmp_path / f"est{len(files)}.txt")
        main([*argv, *extra, "--out", est])
        out = capsys.readouterr()
        assert sum(line.startswith("frame ") for line in out.err.splitlines()) == 7
        with open(est) as fh:
            files.append((fh.read(), _last_json(out.out)))
    assert files[0] == files[1]


def test_cli_pipelined_with_loop_close_exits_as_jax_does():
    """`--pipelined` with `--loop-close` exits with the JAX CLI's message."""
    with pytest.raises(SystemExit) as exc:
        main(["dvo", "--device", "cpu", "--frames", "2", "--pipelined", "--loop-close"])
    assert str(exc.value) == ("--pipelined is incompatible with --viz-dir/--loop-close/"
                              "--map-out (they need per-frame host access)")


def test_cli_runs_without_jax():
    """`dvo --device cpu` at the CLI defaults and `--method subgradient`
    in a fresh process: no jax module is ever loaded."""
    code = (
        "import runpy, sys\n"
        "for extra in ([], ['--method', 'subgradient']):\n"
        "    sys.argv = ['cli', 'dvo', '--device', 'cpu', '--cam-scale', '0.5', '--frames', '2',\n"
        "                '--iterations', '3,2,2,2', *extra]\n"
        "    runpy.run_module('rgbd_odometry_tpu_torch.cli', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "print('JAX_MODULES', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count('"ate_rmse"') == 2


_LC = ["dvo", "--device", "cpu", "--frames", "12", "--cam-scale", "0.5", "--iterations",
       "10,5,3,2", "--keyframe-every", "3", "--loop-close", "--no-feeder"]


@pytest.fixture(scope="module")
def loop_close_run(tmp_path_factory):
    """The JAX loop-closure CLI test's command (tests/test_loop_closure.py)
    on the port, with the trajectory and map written."""
    d = tmp_path_factory.mktemp("lc")
    est, ply = str(d / "est.txt"), str(d / "map.ply")
    summary = main([*_LC, "--out", est, "--map-out", ply])
    return summary, est, ply


def test_cli_loop_close_and_map(loop_close_run, capsys):
    summary, est, ply = loop_close_run
    assert summary["ate_rmse"] < 0.02
    assert len(summary["closures"]) >= 1
    with open(ply, "rb") as f:
        head = f.read(512).decode("latin-1")
    assert head.startswith("ply") and f"element vertex {summary['map_points']}" in head
    assert summary["map_points"] > 0


@pytest.mark.parametrize("flags,line", [
    (["--weighted-refine"], "(information-weighted odometry edges)"),
    (["--refine-mode", "graph"], "graph residual"),
    (["--refine-every", "1"], "online refine @frame"),
    (["--relocalize"], "relocalizer: "),
])
def test_cli_map_backend_modes(flags, line, capsys):
    summary = main([*_LC, *flags])
    err = capsys.readouterr().err
    assert line in err and "loop closures: " in err
    assert summary["ate_rmse"] < 0.02
    if "--relocalize" in flags:
        assert summary["recoveries"] == 0


def _write_constraints(path, summary):
    """The run's closures as `refine --constraints` lines: i j t q weight."""
    from rgbd_odometry_tpu_torch.core.geometry import quat_from_rotmat

    rows = []
    for (i, j, _), (R, t) in zip(summary["closures"], summary["closure_poses"]):
        q = quat_from_rotmat(torch.as_tensor(R)).numpy()
        rows.append([i, j, *t, *q, 3.0])
    np.savetxt(path, np.asarray(rows))


def test_cli_refine_matches_jax(loop_close_run, tmp_path, capsys):
    """`refine --robust geman --covariance-out` on the loop-closure run's
    trajectory and closures: the JAX CLI's JSON (norms within 1e-4
    relative, closure weights within 1e-3) and covariance."""
    from rgbd_odometry_tpu.cli import main as jax_main

    summary, est, _ = loop_close_run
    lc = str(tmp_path / "lc.txt")
    _write_constraints(lc, summary)
    out = {}
    for name, fn, extra in (("port", main, ["--device", "cpu"]), ("jax", jax_main, [])):
        capsys.readouterr()
        fn(["refine", est, "--constraints", lc, "--out", str(tmp_path / f"{name}.txt"),
            "--robust", "geman", "--covariance-out", str(tmp_path / f"{name}.npy"), *extra])
        out[name] = _last_json(capsys.readouterr().out)
    p, j = out["port"], out["jax"]
    assert p["nodes"] == j["nodes"] == 12 and p["loop_closures"] == j["loop_closures"] >= 1
    np.testing.assert_allclose(p["residual_norms"], j["residual_norms"], rtol=1e-4, atol=2e-6)
    assert p["residual_norms"][-1] <= p["residual_norms"][0]
    np.testing.assert_allclose(p["closure_robust_weights"], j["closure_robust_weights"],
                               rtol=1e-3, atol=1e-4)
    cov_p, cov_j = np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy")
    assert cov_p.shape == cov_j.shape == (12, 6, 6)
    assert np.abs(cov_p - cov_j).max() <= 1e-3 * np.abs(cov_j).max()
    _, t_p, _ = read_trajectory(str(tmp_path / "port.txt"))
    _, t_j, _ = read_trajectory(str(tmp_path / "jax.txt"))
    np.testing.assert_allclose(t_p, t_j, rtol=0, atol=1e-5)


def test_cli_map_backend_runs_without_jax(tmp_path):
    """`dvo --loop-close --relocalize --map-out` and `refine` in a fresh
    process: no jax module is ever loaded."""
    est, ply = str(tmp_path / "est.txt"), str(tmp_path / "map.ply")
    code = (
        "import runpy, sys\n"
        f"for argv in ({[*_LC, '--frames', '6', '--relocalize', '--map-out', ply, '--out', est]!r},\n"
        f"             ['refine', {est!r}, '--device', 'cpu', '--out', {est!r}]):\n"
        "    sys.argv = ['cli', *argv]\n"
        "    runpy.run_module('rgbd_odometry_tpu_torch.cli', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "print('JAX_MODULES', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "loop closures: " in r.stderr and '"residual_norms"' in r.stdout
