"""World-frame semi-dense maps and PLY output: the JAX package's numpy-only
`rgbd_odometry_tpu/viz/pointcloud.py` (its package `__init__` is lazy, so
this import pulls in no JAX), re-exported so that callers of the port name
only the port."""

from rgbd_odometry_tpu.viz.pointcloud import compose_map, write_ply  # noqa: F401  (jax-free)

__all__ = ["compose_map", "write_ply"]
