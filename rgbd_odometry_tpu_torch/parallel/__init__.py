"""Batched multi-frame work on one device: port of `rgbd_odometry_tpu/parallel/`.

* `streams.MultiStreamOdometry` — N camera streams advanced in lockstep,
  one batched step per frame;
* `sequence.align_sequence` — a whole sequence's frame pairs (consecutive or
  keyframe-anchored) in one batched `align_pair` call, composed on the host;
* `mesh.build_batch_step` — batched alignment with the batch statistics the
  JAX package reduces across its mesh, on one device;
* `multihost` — the host-side window split and stitching of long sequences.

The JAX package's device-mesh sharding (`mesh.make_mesh`, `shard_batch`,
`build_sharded_aligner`, `build_shardmap_train_step`) and multi-process
set-up (`multihost.initialize`, `global_mesh`) are not ported: they are
ROADMAP.md's multi-GPU item.
"""
