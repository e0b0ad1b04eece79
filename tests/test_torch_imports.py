"""The PyTorch port imports no JAX, its modules (the kernel wrappers
included) import without nvcc, and its chip smoke script refuses to run
without a CUDA device."""

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
              "pipeline.loop_closure", "pipeline.relocalize", "viz.pointcloud"):
        assert f"rgbd_odometry_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import rgbd_odometry_tpu_torch as p\n"
        "p.align_pair, p.EdgeDvoOdometry, p.LoopCloser, p.Relocalizer, p.refine_pose_graph\n"
        "p.information_sqrt, p.marginal_covariance\n"
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
