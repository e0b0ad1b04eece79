"""The port's tracing (`rgbd_odometry_tpu_torch.utils.tracing`) on the CPU:
`Tracer`'s statistics and report against the JAX `Tracer`'s layout,
`block_until_ready`, a `profiler_trace` file, and `dvo --trace-dir`."""

import glob
import json
import os
import time

import pytest

torch = pytest.importorskip("torch")

from rgbd_odometry_tpu.utils.tracing import Tracer as JaxTracer  # noqa: E402
from rgbd_odometry_tpu_torch.cli import main  # noqa: E402
from rgbd_odometry_tpu_torch.utils.tracing import (  # noqa: E402
    StageStats, Tracer, block_until_ready, profiler_trace,
)


def test_stage_statistics():
    s = StageStats()
    for dt in (0.002, 0.004, 0.003):
        s.add(dt)
    assert s.count == 3 and s.min_s == 0.002 and s.max_s == 0.004
    assert s.mean_ms == pytest.approx(3.0)
    assert StageStats().mean_ms == 0.0


def test_tracer_times_stages_and_reports_like_jax(tmp_path):
    tr = Tracer()
    x = torch.ones(8)
    for _ in range(3):
        with tr.stage("sleep", block_on={"x": [x, (x,)]}):
            time.sleep(0.002)

    @tr.timed("double")
    def double(a):
        return a * 2

    assert torch.equal(double(x), x * 2)
    rep = tr.report()
    assert rep["sleep"]["count"] == 3 and rep["double"]["count"] == 1
    assert rep["sleep"]["min_ms"] >= 2.0 - 1e-6
    assert rep["sleep"]["min_ms"] <= rep["sleep"]["mean_ms"] <= rep["sleep"]["max_ms"]
    jt = JaxTracer()
    with jt.stage("sleep"):
        pass
    assert rep["sleep"].keys() == jt.report()["sleep"].keys()
    path = str(tmp_path / "stages.json")
    assert json.loads(tr.dump(path)) == json.loads(open(path).read()) == json.loads(
        json.dumps(rep, sort_keys=True))
    off = Tracer(enabled=False)
    with off.stage("none"):
        pass
    assert off.report() == {}


def test_block_until_ready_returns_its_argument():
    tree = {"a": torch.zeros(2), "b": [1, (torch.ones(1),)]}
    assert block_until_ready(tree) is tree


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with profiler_trace(d):
        a = torch.randn(64, 64)
        (a @ a).sum()
    files = glob.glob(os.path.join(d, "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any("aten::mm" in str(e.get("name", "")) for e in events)


def test_cli_trace_dir_keeps_the_trajectory(tmp_path, capsys):
    argv = ["dvo", "--device", "cpu", "--cam-scale", "0.5", "--frames", "3", "--iterations",
            "4,3,2,2"]
    main([*argv, "--out", str(tmp_path / "a.txt")])
    main([*argv, "--trace-dir", str(tmp_path / "tr"), "--out", str(tmp_path / "b.txt")])
    assert f"torch.profiler trace -> {tmp_path / 'tr'}" in capsys.readouterr().err
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    files = glob.glob(str(tmp_path / "tr" / "*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name", "") for e in json.load(open(files[0]))["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


@pytest.mark.parametrize("ranges", [True, False])
def test_kernel_ranges_open_only_while_a_profiler_records_and_the_flag_is_set(monkeypatch,
                                                                             ranges):
    """`build.traced` names a kernel launch in a trace while a profiler
    records; `profile_paths` clears `build.ranges` so that its windows time
    the path without the ranges."""
    from torch.profiler import ProfilerActivity, profile

    from rgbd_odometry_tpu_torch.kernels import build

    monkeypatch.setattr(build, "ranges", ranges)
    with build.traced("outside"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with build.traced("inside"):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert ("inside" in names) == ranges and "outside" not in names
