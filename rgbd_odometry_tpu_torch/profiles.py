"""Canonical solver profiles: the port's own copy of
`rgbd_odometry_tpu/profiles.py` (tests/test_torch_config.py holds the two
equal field for field), the tuned configurations that bench.py,
tools/accuracy_sweep.py and the validation sweeps all share.

The reference runs ONE configuration: 320x240 base (VGA level explicitly
skipped as too expensive, reference src/camTopic2PublisherPyD.cpp:341-345
"thtz too big for now"), 4 pyramid levels, 50 sub-gradient iterations per
level (reference src/SolveDVO.cpp:29-34). The TPU rebuild keeps that
exact configuration as ``parity_320`` and adds two tuned ones:

``production_320``
    The bench/production LM profile at the reference's working resolution.
    Every knob here was adopted by an A/B measured on the real chip and an
    accuracy sweep showing equal-or-better pose error (BASELINE.md round-2/3
    kernel A/B tables).

``production_vga``
    The true-VGA profile the reference could not afford: 5 levels with the
    full 640x480 frame as level 0. Levels 1..4 are geometrically identical
    to ``production_320``'s levels 0..3 (same resolutions, same scaled
    intrinsics), so the coarse-to-fine schedule reuses the tuned 320 ladder
    and the VGA level is a final refinement pass on 4x the pixels with
    sub-pixel-converged initialization from level 1.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

from .config import CameraConfig, SolverConfig


class Profile(NamedTuple):
    """A complete solve configuration: camera base resolution + pyramid
    layout + solver knobs. ``camera`` is the level-0 calibration."""

    name: str
    camera: CameraConfig
    solver: SolverConfig
    max_points: Tuple[int, ...]

    @property
    def num_levels(self) -> int:
        return len(self.max_points)


#: TUM Freiburg-1 ROS-default calibration at full VGA
#: (reference src/camTopic2PublisherPyD.cpp:443-451 halves these for
#: the 320x240 solver; the unhalved values are the sensor's).
_VGA_CAM = CameraConfig(
    width=640, height=480, fx=525.0, fy=525.0, cx=319.5, cy=239.5
)


def parity_320() -> Profile:
    """The reference's own configuration, constant-for-constant."""
    return Profile(
        name="parity_320",
        camera=CameraConfig(),
        solver=SolverConfig(method="subgradient"),
        max_points=(8192, 4096, 2048, 1024),
    )


def production_320() -> Profile:
    """The tuned LM profile at the reference's 320x240 working resolution
    (the bench.py headline configuration)."""
    return Profile(
        name="production_320",
        camera=CameraConfig(),
        solver=SolverConfig(
            method="gauss_newton",
            iterations=(18, 6, 4, 3),
            lm_jacobian_stride=8,
            edt_window=16,
            normalize_dt=False,
            lm_deferred_accept=True,
            extract_selection="segmented",
        ),
        max_points=(2048, 1024, 512, 512),
    )


def production_vga(vga_iterations: int = 4) -> Profile:
    """True-VGA 5-level profile: 640x480 base, coarse ladder = production_320.

    ``vga_iterations`` LM iterations on the full-resolution level refine the
    level-1 (=320x240) solution; initialization there is already sub-pixel
    at VGA scale, so the level is a polish pass, not a search. The polish
    SATURATES by 4 iterations: the r5 on-chip A/B measured 4 vs 8 equal on
    every family x magnitude combo (identical worst case, 6.87 mm; full
    18-combo sweep re-run at 4 wins all 18 vs production_320 exactly like
    the 8-iteration record — validation/refbuild/VGA_SWEEP_r5.log), so the
    default takes the cheaper schedule.
    """
    p320 = production_320()
    return Profile(
        name="production_vga",
        camera=_VGA_CAM,
        solver=dataclasses.replace(
            p320.solver, iterations=(vga_iterations,) + p320.solver.iterations
        ),
        max_points=(4096,) + p320.max_points,
    )
