"""Batched multi-frame work, on one device or over the ranks of a
`torch.distributed` process group: port of `rgbd_odometry_tpu/parallel/`.

* `streams.MultiStreamOdometry` — N camera streams advanced in lockstep,
  one batched step per frame, the streams split over the ranks;
* `sequence.align_sequence` — a whole sequence's frame pairs (consecutive or
  keyframe-anchored) in one batched `align_pair` call a rank, composed on
  the host;
* `mesh` — a rank's place (`Mesh`, `make_mesh`; `local_mesh`, the
  world-1 mesh the entry points take without one), its rows of a batch
  (`shard_batch`), the sharded aligner and train step, and the one-device
  batch step (the train step's world-1 case) with the batch statistics
  the JAX package reduces across its mesh;
* `multihost` — the process group's set-up (`initialize`, `shutdown`,
  `global_mesh`, a rank's place on its host) and the window split and
  stitching of long sequences;
* `launch` — W ranks of a function started on one host and joined by a
  deadline, and a count of the collectives a block calls.

A rank is one process driving one device: NCCL carries device tensors
between ranks that each have a card, gloo the host objects and, on the CPU
or where ranks share a card, everything. Streams and pairs never exchange
data; the batch statistics (one `all_reduce` a train step) and the results
the host composes (one gather a call or a run) are all that cross ranks.
"""
