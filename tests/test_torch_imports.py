"""The PyTorch port imports no JAX and nothing of the JAX package
`rgbd_odometry_tpu`, its modules (the kernel wrappers included) import
without nvcc, and its chip smoke script refuses to run without a CUDA
device."""

import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "rgbd_odometry_tpu_torch")


def _port_modules():
    mods = []
    for root, _dirs, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3].replace(os.sep, ".")
                mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return sorted(mods)


def test_port_modules_import_without_jax():
    mods = _port_modules()
    for m in ("solvers.edge_dvo", "kernels.residual", "kernels.sg_terms", "pipeline.feeder",
              "io.stream", "io.tum", "cli", "kernels.match", "kernels.pnp_gn", "ops.features",
              "ops.epipolar", "solvers.pnp", "solvers.pose_graph", "pipeline.kf_matcher",
              "pipeline.loop_closure", "pipeline.relocalize", "viz.pointcloud", "core.camera",
              "core.pyramid", "pipeline.odometry", "profile_paths"):
        assert f"rgbd_odometry_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import rgbd_odometry_tpu_torch as p\n"
        "p.align_pair, p.EdgeDvoOdometry, p.LoopCloser, p.Relocalizer, p.refine_pose_graph\n"
        "p.information_sqrt, p.marginal_covariance\n"
        "p.EdgeDvoOdometry.process_stream\n"
        "from rgbd_odometry_tpu_torch.io.stream import preprocess_vga\n"
        "from rgbd_odometry_tpu_torch.core.pyramid import pyramid_from_vga, rgb_to_gray\n"
        "from rgbd_odometry_tpu_torch.core.camera import remap_bilinear, undistort_map\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "print('JAX_MODULES', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    # no nvcc on the PATH: the kernel wrappers build only when they launch
    env = dict(os.environ, PYTHONPATH=REPO, PATH=os.path.dirname(sys.executable))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_fails_without_cuda():
    """On a host without a card the script exits non-zero and prints no
    result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _names_jax_package(name: str) -> bool:
    return name in ("jax", "rgbd_odometry_tpu") or name.startswith(("jax.", "rgbd_odometry_tpu."))


def test_port_sources_import_nothing_of_the_jax_package():
    """An AST scan of every module of the port and of chip_smoke.py: no
    `import` or `from ... import` of `jax` or of `rgbd_odometry_tpu` (the
    `_torch` package aside), at module level or inside a function."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names if _names_jax_package(n)]
    assert len(files) > 40
    assert not bad, bad


_BLOCKER = """
import importlib.abc, sys


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "rgbd_odometry_tpu", "cv2") or name.startswith(
                ("jax.", "rgbd_odometry_tpu.", "cv2.")):
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, _Block())
"""
_LOADED = ("print('LOADED', sorted(m for m in sys.modules\n"
           "                      if m.split('.')[0] in ('jax', 'rgbd_odometry_tpu', 'cv2')))\n")


def test_port_runs_with_the_jax_package_blocked(tmp_path):
    """With a `sys.meta_path` finder that raises on `rgbd_odometry_tpu`,
    `jax` and `cv2`, every port module imports and the CLI runs `dvo` on two
    frames and `eval` on its output."""
    est = str(tmp_path / "est.txt")
    code = _BLOCKER + (
        "import importlib\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "from rgbd_odometry_tpu_torch.cli import main\n"
        f"main(['dvo', '--device', 'cpu', '--frames', '2', '--cam-scale', '0.25', '--out', {est!r}])\n"
        f"main(['eval', {est!r}, {est!r}])\n"
        + _LOADED
    )
    env = dict(os.environ, PYTHONPATH=REPO, PATH=os.path.dirname(sys.executable))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout
    assert '"ate_rmse_raw": 0.0' in r.stdout


def test_slice_runs_with_the_jax_package_and_cv2_blocked(tmp_path):
    """With `rgbd_odometry_tpu`, `jax` and `cv2` blocked, as on the machine
    with the card: `dvo --checkpoint`, then `--resume`, `--viz-dir` and
    `--trace-dir`, `dump`, `dvo --source xml:` with a `calib`-written file,
    `probe` and `calib --write-freiburg`."""
    dvo = ["dvo", "--device", "cpu", "--cam-scale", "0.5", "--iterations", "4,3,2,2"]
    c, dumps, cal = str(tmp_path / "c.npz"), str(tmp_path / "dumps"), str(tmp_path / "cal")
    os.makedirs(cal)
    runs = [
        [*dvo, "--frames", "3", "--checkpoint", c],
        [*dvo, "--frames", "5", "--resume", c, "--viz-dir", str(tmp_path / "viz"),
         "--viz-every", "1", "--trace-dir", str(tmp_path / "tr")],
        ["dump", "--device", "cpu", "--cam-scale", "0.5", "--frames", "2", "--out-dir", dumps],
        ["calib", "--write-freiburg", cal],
        ["probe", "--device", "cpu", "--level", "3", "--iterations", "4"],
    ]
    code = _BLOCKER + (
        "import os, sys\n"
        "from rgbd_odometry_tpu_torch.cli import main\n"
        "from rgbd_odometry_tpu_torch.config import CameraConfig\n"
        "from rgbd_odometry_tpu_torch.io.calib import write_calib_xml\n"
        f"for argv in {runs!r}:\n"
        "    main(argv)\n"
        f"cam = os.path.join({cal!r}, 'cam_160x120.xml')\n"
        "write_calib_xml(cam, CameraConfig().scaled(0.5))\n"
        f"main(['dvo', '--device', 'cpu', '--source', 'xml:' + {dumps!r}, '--calib', cam,\n"
        "      '--iterations', '4,3,2,2'])\n"
        + _LOADED
    )
    env = dict(os.environ, PYTHONPATH=REPO, PATH=os.path.dirname(sys.executable))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout
    assert "resumed at frame 2" in r.stderr and "viz: " in r.stderr
    assert "torch.profiler trace -> " in r.stderr
    assert len(os.listdir(dumps)) == 2 and '"frames_written": 2' in r.stdout
    assert sorted(os.listdir(cal))[:2] == ["Freiburg_ROS_default_320x240.xml",
                                           "Freiburg_ROS_default_640x480.xml"]
    assert '"best_iter"' in r.stdout and r.stdout.count('"ate_rmse"') == 2
    assert r.stderr.rstrip().split("avg solve: ")[-1].endswith("over 2 frames")  # the xml: run


_SLICE_MODULES = ("utils/checkpoint.py", "utils/tracing.py", "viz/live.py", "viz/png.py",
                  "viz/colormap.py", "viz/overlay.py", "io/opencv_xml.py", "io/xml_dump.py",
                  "io/calib.py", "solvers/photometric.py", "cli.py", "pipeline/odometry.py")


@pytest.mark.parametrize("rel", _SLICE_MODULES)
def test_checkpoint_viz_and_xml_modules_import_no_cv2(rel):
    """An AST scan: the checkpoint, tracing, viz and XML modules, the CLI
    and the driver import no cv2 anywhere (their files are written and read
    with zlib and the port's own XML codec)."""
    with open(os.path.join(PKG, rel)) as fh:
        tree = ast.parse(fh.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names if n == "cv2" or n.startswith("cv2.")]
