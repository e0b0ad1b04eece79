"""The port's OpenCV-XML files without OpenCV (`io/opencv_xml.py`,
`io/xml_dump.py`, `dump`, the `xml:` source) on the CPU: cv2 reads the
port's files and the port reads cv2's, bitwise; the port's frame dumps are
the JAX package's byte for byte; every dumped level reads back bitwise; and
`dvo --source xml:` on the same dumps matches the JAX command within
tests/test_torch_cli.py's bars."""

import os

import numpy as np
import pytest

pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from rgbd_odometry_tpu.cli import main as jax_main  # noqa: E402
from rgbd_odometry_tpu.io import xml_dump as jax_xml  # noqa: E402
from rgbd_odometry_tpu_torch.cli import main  # noqa: E402
from rgbd_odometry_tpu_torch.config import CameraConfig  # noqa: E402
from rgbd_odometry_tpu_torch.io import xml_dump  # noqa: E402
from rgbd_odometry_tpu_torch.io.calib import write_calib_xml  # noqa: E402
from rgbd_odometry_tpu_torch.io.opencv_xml import read_opencv_xml, write_opencv_xml  # noqa: E402
from rgbd_odometry_tpu_torch.io.tum import read_trajectory  # noqa: E402


def _pyramid(rng, h=24, w=32, levels=4):
    gray = [rng.uniform(-3, 260, (h >> k, w >> k)) for k in range(levels)]
    depth = [np.where(rng.random((h >> k, w >> k)) < 0.1, 0.0,
                      rng.uniform(0, 70000, (h >> k, w >> k))) for k in range(levels)]
    return gray, depth


def test_cv2_reads_the_port_files_and_the_port_reads_cv2s(tmp_path):
    rng = np.random.default_rng(0)
    nodes = {"m8": rng.integers(0, 256, (13, 37), dtype=np.uint8),
             "m16": rng.integers(0, 65536, (9, 41), dtype=np.uint16),
             "i32": rng.integers(-2 ** 31, 2 ** 31, (3, 7), dtype=np.int32),
             "f64": rng.normal(0, 1e3, (4, 11)), "col": np.array([[0.25], [-1.0], [3e-7]]),
             "width": 640}
    mine, theirs = str(tmp_path / "mine.xml"), str(tmp_path / "theirs.xml")
    write_opencv_xml(mine, nodes)
    fs = cv2.FileStorage(theirs, cv2.FILE_STORAGE_WRITE)
    for k, v in nodes.items():
        fs.write(k, v)
    fs.release()
    assert open(mine).read() == open(theirs).read()
    fs = cv2.FileStorage(mine, cv2.FILE_STORAGE_READ)
    for k, v in nodes.items():
        node = fs.getNode(k)
        got = node.mat() if node.isMap() else int(node.real())
        assert np.asarray(got).dtype == np.asarray(v).dtype and np.array_equal(got, v), k
    fs.release()
    back = read_opencv_xml(theirs)
    for k, v in nodes.items():
        assert np.asarray(back[k]).dtype == np.asarray(v).dtype and np.array_equal(back[k], v), k


def test_frame_dumps_are_jax_byte_for_byte(tmp_path):
    """`write_frame_dump` writes the file JAX's (cv2's) writer does; both
    readers give the same levels from either file; each level reads back
    as the rounded, clipped values written."""
    rng = np.random.default_rng(1)
    gray, depth = _pyramid(rng)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    mine = xml_dump.write_frame_dump(str(tmp_path / "p"), 7, gray, depth)
    theirs = jax_xml.write_frame_dump(str(tmp_path / "j"), 7, gray, depth)
    assert os.path.basename(mine) == os.path.basename(theirs) == "framemono_0007.xml"
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    for path in (mine, theirs):
        g, d = xml_dump.read_frame_dump(path)
        gj, dj = jax_xml.read_frame_dump(path)
        for a, b, src, hi in zip(g + d, gj + dj, gray + depth, [255] * 4 + [65535] * 4):
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
            assert np.array_equal(a, np.clip(np.round(src), 0, hi))
    with pytest.raises(ValueError, match="missing mono_4"):
        xml_dump.read_frame_dump(mine, num_levels=5)


def test_sources_and_listing_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    for i in (0, 3, 1, 12):
        xml_dump.write_frame_dump(str(tmp_path), i, *_pyramid(rng, 16, 16))
    (tmp_path / "notes.txt").write_text("not a dump")
    assert xml_dump.list_dump_frames(str(tmp_path)) == jax_xml.list_dump_frames(str(tmp_path))
    assert xml_dump.frame_path("d", 5) == jax_xml.frame_path("d", 5)
    for kw in ({}, {"start": 1, "end": 3}):
        mine = list(xml_dump.XmlDumpSource(str(tmp_path), **kw).frames())
        theirs = list(jax_xml.XmlDumpSource(str(tmp_path), **kw).frames())
        assert len(mine) == len(theirs) == (4 if not kw else 2)
        for a, b in zip(mine, theirs):
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2] == b[2]
            assert (a[1] > 0).all()
        for a, b in zip(xml_dump.XmlDumpSource(str(tmp_path), **kw).pyramids(),
                        jax_xml.XmlDumpSource(str(tmp_path), **kw).pyramids()):
            assert all(np.array_equal(x, y) for x, y in zip(a[0] + a[1], b[0] + b[1]))


def test_frame_source_protocol_matches_jax(tmp_path):
    """The port's `io.stream.FrameSource` declares `frames()` as JAX's does
    (a typing Protocol, the same signature and annotation), and the sources
    the port replays, the XML dumps' among them, provide it and yield its
    (gray, depth_mm, timestamp) triples."""
    import inspect
    from typing import Protocol

    from rgbd_odometry_tpu.io import stream as jax_stream
    from rgbd_odometry_tpu_torch.io import stream

    mine, theirs = stream.FrameSource, jax_stream.FrameSource
    assert Protocol in mine.__bases__ and Protocol in theirs.__bases__
    assert [n for n in vars(mine) if not n.startswith("_")] == ["frames"]
    assert inspect.signature(mine.frames) == inspect.signature(theirs.frames)
    assert mine.frames.__annotations__ == theirs.frames.__annotations__
    assert "FrameSource" in xml_dump.XmlDumpSource.__doc__
    assert "FrameSource" in jax_xml.XmlDumpSource.__doc__
    for source in (xml_dump.XmlDumpSource, stream.SyntheticCamera, stream.TumSource):
        assert inspect.signature(source.frames) == inspect.signature(mine.frames).replace(
            return_annotation=inspect.Signature.empty)
    xml_dump.write_frame_dump(str(tmp_path), 0, *_pyramid(np.random.default_rng(3), 16, 16))
    gray, depth, ts = next(iter(xml_dump.XmlDumpSource(str(tmp_path)).frames()))
    assert gray.shape == depth.shape == (16, 16) and ts == 0.0


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """`dump` of 4 rendered 160x120 frames by the port and by JAX, and a
    calibration file for them."""
    d = tmp_path_factory.mktemp("dumps")
    argv = ["dump", "--cam-scale", "0.5", "--frames", "4", "--levels", "4"]
    port = main([*argv, "--out-dir", str(d / "port"), "--device", "cpu"])
    jax_main([*argv, "--out-dir", str(d / "jax")])
    calib = str(d / "cam_160x120.xml")
    write_calib_xml(calib, CameraConfig().scaled(0.5))
    return d, port, calib


def test_dump_command_writes_jax_files(dumps):
    d, port, _ = dumps
    assert port == {"frames_written": 4, "dir": str(d / "port")}
    names = sorted(os.listdir(d / "port"))
    assert names == sorted(os.listdir(d / "jax")) == [f"framemono_{i:04d}.xml" for i in range(4)]
    for n in names:
        assert (d / "port" / n).read_bytes() == (d / "jax" / n).read_bytes(), n
    g, dep = xml_dump.read_frame_dump(str(d / "port" / names[0]))
    assert [x.shape for x in g] == [(120, 160), (60, 80), (30, 40), (15, 20)]


def test_dvo_xml_source_matches_jax(dumps, tmp_path, capsys):
    """`dvo --source xml:<dir> --calib` on the same dumps: the JAX command's
    trajectory within 1e-3 (positions) and 2e-3 (rotations)."""
    d, _, calib = dumps
    argv = ["dvo", "--source", f"xml:{d / 'port'}", "--calib", calib, "--iterations", "8,4,3,2"]
    main([*argv, "--device", "cpu", "--out", str(tmp_path / "p.txt")])
    jax_main([*argv, "--out", str(tmp_path / "j.txt")])
    assert "frame    3" in capsys.readouterr().err
    R_p, t_p, ts_p = read_trajectory(str(tmp_path / "p.txt"))
    R_j, t_j, ts_j = read_trajectory(str(tmp_path / "j.txt"))
    assert t_p.shape == (4, 3) and np.array_equal(ts_p, ts_j)
    assert np.linalg.norm(t_p - t_j, axis=-1).max() < 1e-3
    assert np.abs(R_p - R_j).max() < 2e-3
    assert np.linalg.norm(t_p[-1]) > 1e-3  # it tracked motion
