"""The port's command line (`python -m rgbd_odometry_tpu_torch.cli`) on the
CPU: `dvo` at the JAX CLI's defaults against the JAX `EdgeDvoOdometry` and
ground truth, `eval`, `--gt` files, a short sub-gradient run, the feeder, TUM replay
against the JAX `TumSource`, `--cam-scale 3`, the map backend (`--loop-close` in both
refine modes, online and information-weighted, `--map-out`, `--relocalize`, and `refine`
against the JAX CLI's JSON), `calib` and `probe` against the JAX commands,
`photometric`, `imu` and `pnp` against the JAX commands, `feature-vo` and `fused
--imu-refine` at the JAX CLI tests' bars, the unported subcommand, and no JAX at
import. `--checkpoint`/`--resume` are in
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
    ("bench", "item 1 'H100 bench protocol'"),
])
def test_cli_unported_subcommands_exit_naming_their_roadmap_item(cmd, item):
    """The JAX subcommand not ported yet parses the JAX parser's flags, then
    exits naming its ROADMAP.md Queue 1 item by number and by name."""
    flags = {"bench": ["--batch", "4"]}[cmd]
    with pytest.raises(SystemExit) as exc:
        main([cmd, *flags])
    assert "not ported to rgbd_odometry_tpu_torch" in str(exc.value)
    assert f"ROADMAP.md Queue 1, {item}" in str(exc.value)


def test_cli_photometric_matches_jax(tmp_path, capsys):
    """`photometric --huber` at the 320x240 default camera and at the JAX
    tests' 160x120 with every level solved to completion: the trajectory
    file within 1e-5 of JAX's (the photometric pose bar), one stderr line a
    solved frame with |eps| within 1e-4 relative of JAX's."""
    from rgbd_odometry_tpu.cli import main as jax_main

    for flags in (["--frames", "4", "--huber"], ["--frames", "3", "--cam-scale", "0.5"]):
        files = {}
        errs = {}
        for name, fn in (("port", main), ("jax", jax_main)):
            files[name] = str(tmp_path / f"{name}.txt")
            extra = ["--device", "cpu"] if name == "port" else []
            fn(["photometric", *flags, "--out", files[name], *extra])
            errs[name] = [float(line.split()[-1]) for line in capsys.readouterr().err.splitlines()
                          if line.startswith("frame ")]
        R_p, t_p, ts_p = read_trajectory(files["port"])
        R_j, t_j, ts_j = read_trajectory(files["jax"])
        n = int(flags[1])
        assert t_p.shape == (n, 3) and len(errs["port"]) == n - 1
        np.testing.assert_allclose(ts_p, ts_j, atol=1e-6)
        np.testing.assert_allclose(t_p, t_j, rtol=0, atol=1e-5)
        np.testing.assert_allclose(R_p, R_j, rtol=0, atol=1e-5)
        np.testing.assert_allclose(errs["port"], errs["jax"], rtol=1e-4)


def test_cli_photometric_matches_jax_over_25_frames(tmp_path, capsys):
    """`photometric --huber --frames 25` at the 320x240 default camera, a
    longer run than the test above (both packages take ~58 s on one CPU
    worker; 30 frames take ~64 s): every pose of the trajectory file within
    1e-5 of JAX's, every solved frame's |eps| within 1e-4 relative."""
    from rgbd_odometry_tpu.cli import main as jax_main

    files, errs = {}, {}
    for name, fn in (("port", main), ("jax", jax_main)):
        files[name] = str(tmp_path / f"{name}.txt")
        extra = ["--device", "cpu"] if name == "port" else []
        fn(["photometric", "--frames", "25", "--huber", "--out", files[name], *extra])
        errs[name] = [float(line.split()[-1]) for line in capsys.readouterr().err.splitlines()
                      if line.startswith("frame ")]
    R_p, t_p, ts_p = read_trajectory(files["port"])
    R_j, t_j, ts_j = read_trajectory(files["jax"])
    assert t_p.shape == (25, 3) and len(errs["port"]) == 24
    np.testing.assert_allclose(ts_p, ts_j, atol=1e-6)
    np.testing.assert_allclose(t_p, t_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(R_p, R_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(errs["port"], errs["jax"], rtol=1e-4)


def test_cli_imu_matches_jax(tmp_path, capsys):
    """`imu` (the synthetic yaw, 400 samples, with biases) and `imu --csv`
    (random samples): the JSON within 1e-6 of JAX's."""
    from rgbd_odometry_tpu.cli import main as jax_main

    rng = np.random.default_rng(0)
    csv = str(tmp_path / "imu.csv")
    np.savetxt(csv, np.column_stack([np.arange(50) * 0.01, rng.normal(0, 1.0, (50, 3)),
                                     rng.normal(0, 0.3, (50, 3))]), delimiter=",")
    for flags in (["--steps", "400", "--accel-bias", "0.05", "--gyro-bias", "0.01"],
                  ["--csv", csv]):
        main(["imu", *flags, "--device", "cpu"])
        got = _last_json(capsys.readouterr().out)
        jax_main(["imu", *flags])
        want = _last_json(capsys.readouterr().out)
        assert got["steps"] == want["steps"]
        np.testing.assert_allclose(got["final_p"], want["final_p"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["final_q"], want["final_q"], rtol=0, atol=1e-6)


def _jax_pnp_norms():
    """JAX's `pnp` command's board and solve (`cmd_pnp`): the float32
    residual norms, and those of the same problem solved in float64."""
    import jax
    import jax.numpy as jnp

    from rgbd_odometry_tpu.core import geometry as jgeo
    from rgbd_odometry_tpu.solvers import pnp as jpnp

    obj = jnp.asarray(jpnp.chessboard_object_points(6, 9, 0.05)) + jnp.asarray([0.0, 0.0, 1.5])
    R_gt, t_gt = jgeo.se3_exp(jnp.asarray(np.array([0.08, -0.05, 0.03, 0.05, -0.06, 0.04],
                                                   np.float32)))
    pb = jnp.einsum("kj,nk->nj", R_gt, obj - t_gt)
    imn = pb[:, :2] / pb[:, 2:3]
    valid = jnp.ones(obj.shape[0], bool)
    r32 = np.asarray(jpnp.gn_pnp(obj, imn, valid, iterations=5)[2], np.float64)
    with jax.enable_x64():
        r64 = jpnp.gn_pnp(jnp.asarray(np.asarray(obj), jnp.float64),
                          jnp.asarray(np.asarray(imn), jnp.float64), valid, iterations=5)[2]
        assert r64.dtype == jnp.float64
        r64 = np.asarray(r64)
    return r32, r64


def test_cli_pnp_matches_jax(capsys):
    """`pnp`: the chessboard pose to t_err < 1e-4 (as JAX's), and the first
    residual norm within 1e-6 relative of JAX's. The later ones are float32
    noise of the planar board's normal equations (condition ~5.7e4): against
    the same problem solved in float64, the port's largest relative
    distance over them is no larger than JAX's own (JAX's sit up to 4.6%
    from float64's), and they are held within 5e-2 relative of JAX's
    (PERF.md section 6: the 1e-6 bar is not met there)."""
    from rgbd_odometry_tpu.cli import main as jax_main

    got = main(["pnp", "--device", "cpu"])
    out = _last_json(capsys.readouterr().out)
    jax_main(["pnp"])
    want = _last_json(capsys.readouterr().out)
    assert out["t_err"] < 1e-4 and want["t_err"] < 1e-4
    rn = np.asarray(got["residual_norms_raw"], np.float64)
    assert len(rn) == len(want["residual_norms"]) == 5
    assert abs(rn[0] - want["residual_norms"][0]) <= 1e-6 * want["residual_norms"][0] + 5e-7
    np.testing.assert_allclose(rn, want["residual_norms"], rtol=5e-2, atol=1e-6)
    r32, r64 = _jax_pnp_norms()
    assert [round(float(x), 6) for x in r32] == want["residual_norms"]
    port_off = np.abs(rn[1:] - r64[1:]) / r64[1:]
    jax_off = np.abs(r32[1:] - r64[1:]) / r64[1:]
    assert port_off.max() <= jax_off.max(), (port_off, jax_off)


def test_cli_feature_vo(tmp_path, capsys):
    """JAX's `test_cli_feature_vo` on the port (4 frames, --min-matches 8:
    a line a frame naming the good matches, 4 trajectory rows), and the
    final position within JAX's `test_feature_vo_tracks` bar of 0.1 m."""
    est = str(tmp_path / "fv.txt")
    got = main(["feature-vo", "--frames", "4", "--min-matches", "8", "--out", est,
                "--device", "cpu"])
    err = capsys.readouterr().err
    assert err.count("good matches") == 4
    _, t, _ = read_trajectory(est)
    assert t.shape == (4, 3)
    gt_t = got["gt"][1]
    assert np.linalg.norm(t[-1] - gt_t[3]) < 0.1


def test_cli_fused_imu_refine(tmp_path, capsys):
    """JAX's `test_cli_fused` on the port (6 frames, --imu-refine): the JSON
    counts 6 frames, ATE < 0.02 m, the refined trajectory no worse than the
    visual one (+1e-4), a stderr line a frame and 6 trajectory rows."""
    est = str(tmp_path / "fused.txt")
    main(["fused", "--frames", "6", "--iterations", "10,5,3,2", "--out", est, "--imu-refine",
          "--device", "cpu"])
    out = capsys.readouterr()
    summary = _last_json(out.out)
    assert summary["frames"] == 6
    assert summary["ate_rmse"] < 0.02
    assert summary["ate_rmse"] <= summary["ate_rmse_unrefined"] + 1e-4
    assert sum(line.startswith("frame ") for line in out.err.splitlines()) == 6
    assert np.loadtxt(est, comments="#").shape[0] == 6


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
