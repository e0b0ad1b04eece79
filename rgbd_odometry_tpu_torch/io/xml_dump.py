"""Reference frame-dump interop, OpenCV-XML pyramid files: the port's copy of
`rgbd_odometry_tpu/io/xml_dump.py`, reading and writing through
`io/opencv_xml.py` (no OpenCV).

The reference's offline dataset mode dumps each frame's 4-level pyramid to
one cv::FileStorage XML, nodes `mono_0..3` (CV_8U gray) and `depth_0..3`
(CV_16U millimetres), in files named `framemono_%04d.xml` (writer: reference
src/publisherPyD.cpp:216-256; reader: `SolveDVO::loadFromFile`, reference
src/SolveDVO.cpp:154-190). Frames dumped by the reference replay here
(`cli dvo --source xml:<dir>`), and frames dumped here replay in the
reference's offline mode.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from rgbd_odometry_tpu_torch.io.opencv_xml import read_opencv_xml, write_opencv_xml

_FRAME_RE = re.compile(r"framemono_(\d+)\.xml$")


def frame_path(directory: str, frame_idx: int) -> str:
    """`%s/framemono_%04d.xml` (reference src/SolveDVO.cpp:1961)."""
    return os.path.join(directory, f"framemono_{frame_idx:04d}.xml")


def write_frame_dump(
    directory: str,
    frame_idx: int,
    gray_pyr: Sequence[np.ndarray],
    depth_mm_pyr: Sequence[np.ndarray],
) -> str:
    """Write one frame's pyramid in the reference's dump format.

    `gray_pyr` entries are 0..255-valued (any float/int dtype, stored CV_8U,
    rounded half to even and clipped); `depth_mm_pyr` entries are
    millimetres (stored CV_16U, the converter node's depth encoding).
    """
    nodes = {}
    for i, (g, d) in enumerate(zip(gray_pyr, depth_mm_pyr)):
        nodes[f"mono_{i}"] = np.clip(np.round(np.asarray(g, np.float64)), 0, 255).astype(np.uint8)
        nodes[f"depth_{i}"] = np.clip(np.round(np.asarray(d, np.float64)), 0,
                                      65535).astype(np.uint16)
    path = frame_path(directory, frame_idx)
    write_opencv_xml(path, nodes)
    return path


def read_frame_dump(
    path: str, num_levels: int = 4
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Read one dump file -> (gray_pyr float32, depth_mm_pyr float32), levels
    0..num_levels-1, as `loadFromFile` loads them (no depth sanitize here:
    the sources apply the 0 -> 1 fix before the solver)."""
    mats = read_opencv_xml(path)
    gray, depth = [], []
    for i in range(num_levels):
        if f"mono_{i}" not in mats or f"depth_{i}" not in mats:
            raise ValueError(f"{path}: missing mono_{i}/depth_{i} node")
        gray.append(mats[f"mono_{i}"].astype(np.float32))
        depth.append(mats[f"depth_{i}"].astype(np.float32))
    return gray, depth


def list_dump_frames(directory: str) -> List[Tuple[int, str]]:
    """Sorted (frame_idx, path) of every framemono_NNNN.xml in `directory`."""
    out = []
    for name in os.listdir(directory):
        m = _FRAME_RE.search(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort()
    return out


@dataclass
class XmlDumpSource:
    """Replay a directory of XML dumps as a frame source (the reference's
    `__DATA_FROM_XML_FILES__` offline mode with START/END). Yields (gray
    level 0, depth_mm level 0 with 0 -> 1, timestamp = index / fps)."""

    root: str
    start: int = 0
    end: Optional[int] = None
    fps: float = 30.0

    def _entries(self):
        entries = list_dump_frames(self.root)
        if self.end is not None:
            entries = [(i, p) for i, p in entries if i <= self.end]
        return [(i, p) for i, p in entries if i >= self.start]

    def frames(self):
        for idx, path in self._entries():
            gray, depth = read_frame_dump(path)
            d0 = np.where(depth[0] == 0, 1.0, depth[0]).astype(np.float32)
            yield gray[0], d0, idx / self.fps

    def pyramids(self):
        """Full stored pyramids (all levels, no rebuild), depth 0 -> 1."""
        for idx, path in self._entries():
            gray, depth = read_frame_dump(path)
            depth = [np.where(d == 0, 1.0, d).astype(np.float32) for d in depth]
            yield gray, depth, idx / self.fps
