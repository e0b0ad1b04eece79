"""OpenCV-XML calibration file reader/writer: the port's own copy of
`rgbd_odometry_tpu/io/calib.py`.

Parity with the reference's calibration plumbing: `setCameraMatrix` reads a
cv::FileStorage XML with `cameraMatrix` + `distCoeffs`
(reference src/SolveDVO.cpp:88-126); the converter node auto-writes
`Freiburg_ROS_default_{640x480,320x240}.xml` — the half-res file is the full
matrix scaled by 0.5 with K(2,2) reset to 1
(reference src/camTopic2PublisherPyD.cpp:434-455). Reads and writes through
`io/opencv_xml.py`, without OpenCV: the files are byte for byte what
cv2.FileStorage writes.
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np

from rgbd_odometry_tpu_torch.config import CameraConfig
from rgbd_odometry_tpu_torch.io.opencv_xml import read_opencv_xml, write_opencv_xml


def read_calib_xml(path: str, width: int | None = None, height: int | None = None) -> CameraConfig:
    """Load a cv::FileStorage calibration XML into a CameraConfig.

    Resolution comes from (in priority order): explicit width/height args,
    `imageWidth`/`imageHeight` nodes (written by write_calib_xml), or a
    `<W>x<H>` token in the filename (the reference's own convention —
    `Freiburg_ROS_default_640x480.xml`, `Xtion_640x480.xml`). Inferring it
    from the principal point would be wrong for any real calibration whose
    principal point is off-centre, so that is never done.
    """
    K, dist, size = _read_matrices(path)
    fx, fy, cx, cy = float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])
    # fill each missing dimension independently (an explicit width must not
    # suppress the file's own size nodes for the height)
    if size is not None:
        width = width if width is not None else size[0]
        height = height if height is not None else size[1]
    if width is None or height is None:
        m = re.search(r"(\d+)x(\d+)", os.path.basename(path))
        if m:
            width = width if width is not None else int(m.group(1))
            height = height if height is not None else int(m.group(2))
    if width is None or height is None:
        raise ValueError(
            f"{path}: no imageWidth/imageHeight nodes and no WxH in the "
            "filename — pass width/height explicitly"
        )
    d = tuple(float(x) for x in np.asarray(dist).reshape(-1)[:5]) if dist is not None else (0.0,) * 5
    d = (d + (0.0,) * 5)[:5]
    return CameraConfig(width=width, height=height, fx=fx, fy=fy, cx=cx, cy=cy, distortion=d)


def write_calib_xml(path: str, cam: CameraConfig) -> None:
    """Write a cv::FileStorage XML readable by the reference's
    setCameraMatrix (byte for byte what cv2.FileStorage writes)."""
    K = np.array(
        [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]], np.float64
    )
    dist = np.asarray(cam.distortion, np.float64).reshape(-1, 1)
    # extra nodes the reference ignores (cv::FileStorage reads by name) but
    # that make the file self-describing for read_calib_xml
    write_opencv_xml(path, {"cameraMatrix": K, "distCoeffs": dist,
                            "imageWidth": int(cam.width), "imageHeight": int(cam.height)})


def write_freiburg_pair(directory: str, cam_vga: CameraConfig) -> tuple[str, str]:
    """Reproduce the converter's auto-written calibration pair: the VGA file
    plus the half-res file (0.5*K with K22 reset,
    reference src/camTopic2PublisherPyD.cpp:443-451). Note the reference
    halves cx/cy *without* the -0.25px centre correction; kept as-is."""
    p640 = os.path.join(directory, "Freiburg_ROS_default_640x480.xml")
    p320 = os.path.join(directory, "Freiburg_ROS_default_320x240.xml")
    write_calib_xml(p640, cam_vga)
    half = dataclasses.replace(
        cam_vga,
        width=cam_vga.width // 2,
        height=cam_vga.height // 2,
        fx=cam_vga.fx * 0.5,
        fy=cam_vga.fy * 0.5,
        cx=cam_vga.cx * 0.5,
        cy=cam_vga.cy * 0.5,
    )
    write_calib_xml(p320, half)
    return p640, p320


def _read_matrices(path: str):
    nodes = read_opencv_xml(path)
    K = nodes.get("cameraMatrix")
    if not isinstance(K, np.ndarray):
        raise ValueError(f"no cameraMatrix in {path}")
    w, h = nodes.get("imageWidth"), nodes.get("imageHeight")
    size = (int(w), int(h)) if w is not None and h is not None else None
    return K.reshape(3, 3), nodes.get("distCoeffs"), size
