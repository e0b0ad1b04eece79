"""OpenCV `cv::FileStorage` XML files without OpenCV.

`write_opencv_xml` writes one-channel matrices of CV_8U (`u`), CV_16U
(`w`), CV_32S (`i`) and CV_64F (`d`) data and integer scalars byte for byte
as `cv2.FileStorage` writes them: two-space tags, the data on lines of at
most 72 characters indented by four, doubles as `%.17g` (an integral value
as `N.`). `read_opencv_xml` reads every matrix (any one-channel type) and
number node of such a file, written by OpenCV or by this module, into numpy
arrays of the matrix's type and Python numbers. The reference's frame dumps
and calibration files are in this format.
"""

from __future__ import annotations

import re
from typing import Dict, Union

import numpy as np

_DT = {"u": np.uint8, "c": np.int8, "w": np.uint16, "s": np.int16, "i": np.int32,
       "f": np.float32, "d": np.float64}
_CODE = {np.dtype(_DT[k]): k for k in "uwid"}  # what the writer writes
_WRAP = 72

_MAT_RE = re.compile(
    r"<(\w+) type_id=\"opencv-matrix\">\s*<rows>(\d+)</rows>\s*<cols>(\d+)</cols>\s*"
    r"<dt>(\w+)</dt>\s*<data>([^<]*)</data>\s*</\1>", re.S)
_NUM_RE = re.compile(r"<(\w+)>\s*([-+.\w]+)\s*</\1>")


def _token(v, code: str) -> str:
    if code != "d":
        return str(int(v))
    v = float(v)
    if v != v:
        return ".Nan"
    if v in (float("inf"), float("-inf")):
        return ".Inf" if v > 0 else "-.Inf"
    return f"{int(v)}." if v.is_integer() and abs(v) < 2 ** 31 else f"{v:.17g}"


def _matrix(name: str, a: np.ndarray) -> str:
    a = np.asarray(a)
    if a.ndim == 1:
        a = a.reshape(-1, 1)
    if a.ndim != 2 or a.dtype not in _CODE:
        raise ValueError(f"{name}: need a 2-D matrix of {sorted(map(str, _CODE))}, got "
                         f"{a.shape} {a.dtype}")
    code = _CODE[a.dtype]
    lines, cur = [], "   "
    for v in a.reshape(-1).tolist():
        t = _token(v, code)
        if len(cur) + 1 + len(t) > _WRAP and cur != "   ":
            lines.append(cur)
            cur = "   "
        cur += " " + t
    lines.append(cur)
    return (f'<{name} type_id="opencv-matrix">\n  <rows>{a.shape[0]}</rows>\n'
            f"  <cols>{a.shape[1]}</cols>\n  <dt>{code}</dt>\n  <data>\n"
            + "\n".join(lines) + f"</data></{name}>\n")


def write_opencv_xml(path: str, nodes: Dict[str, Union[np.ndarray, int]]) -> None:
    """Write `nodes` in order: numpy arrays as matrices (1-D as a column),
    Python ints as scalars."""
    parts = ['<?xml version="1.0"?>\n<opencv_storage>\n']
    for name, value in nodes.items():
        if isinstance(value, (int, np.integer)) and not isinstance(value, bool):
            parts.append(f"<{name}>{int(value)}</{name}>\n")
        else:
            parts.append(_matrix(name, value))
    parts.append("</opencv_storage>\n")
    with open(path, "w") as f:
        f.write("".join(parts))


def _number(text: str):
    low = text.lower()
    if low in (".nan", "nan"):
        return float("nan")
    if low.lstrip("+-") in (".inf", "inf"):
        return float("-inf") if low.startswith("-") else float("inf")
    try:
        return int(text)
    except ValueError:
        return float(text)


def read_opencv_xml(path: str) -> dict:
    """Every matrix node (numpy, (rows, cols), of the matrix's type) and
    number node (int or float) of an OpenCV XML file, by name."""
    with open(path) as f:
        text = f.read()
    out = {}
    for name, rows, cols, dt, data in _MAT_RE.findall(text):
        if dt not in _DT:
            raise ValueError(f"{path}: {name}: unsupported element type {dt!r}")
        try:
            vals = np.array(data.split(), dtype=np.float64)
        except ValueError:  # .Nan / .Inf
            vals = np.array([_number(v) for v in data.split()], dtype=np.float64)
        out[name] = vals.astype(_DT[dt]).reshape(int(rows), int(cols))
    for name, value in _NUM_RE.findall(_MAT_RE.sub("", text)):
        if name not in ("rows", "cols", "dt"):
            try:
                out[name] = _number(value)
            except ValueError:
                continue
    return out
