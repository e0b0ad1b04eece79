"""Checkpoint and resume of the streaming odometry: the port's copy of
`rgbd_odometry_tpu/utils/checkpoint.py`.

One `.npz` holds the odometry state (trajectory log, keyframe features,
relative pose, counters, the previous frame's pyramid), the relocalizer's and
the loop closer's keyframe stores, the closures and the raw odometry chain of
online refinement, in the JAX module's layout and `__meta__` JSON: each
package reads the other's files. The port adds keys that the JAX loader
ignores:

- each matcher's `torch.Generator` state (`{p}_gen_state`, and its device
  type under `__meta__`), so that RANSAC draws after a resume continue the
  interrupted run's; `{p}_key` holds `jax.random.PRNGKey(seed)`'s value
  (uint32 [0, seed]) for the JAX loader. A generator's state resumes only on
  the device type that wrote it; elsewhere, and on a JAX-written file, the
  matcher starts from its seed;
- `bad_streak`, the lost-frame streak (the JAX file resumes it at 0, which
  delays a relocalization under way);
- `closer.config`, the loop closer's configuration, applied on restore or
  checked against the caller's (the JAX loader rebuilds the closer with
  whatever configuration it is given);
- `refine_state`, the online refinement's keyframe counter and closure
  baseline (`dvo --refine-every`; the JAX command resumes with the baseline
  at the restored closure count, so closures detected but not yet refined
  before the checkpoint never trigger a refine).

The restore reads every array of the file once (the JAX loader indexes the
file inside per-slot loops, which decompresses an array per keyframe); each
loader takes a path or the `Snapshot` that `read_checkpoint` returns, so the
`dvo` command's resume reads the file once for all of them. A file without
the added keys resumes with the JAX behaviour, and `load_odometry` says so
on stderr in one line (`jax_gaps`).
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import TYPE_CHECKING, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

if TYPE_CHECKING:
    from rgbd_odometry_tpu_torch.pipeline.loop_closure import LoopCloser
    from rgbd_odometry_tpu_torch.pipeline.odometry import EdgeDvoOdometry

_KPS = (("uv", "uv"), ("score", "score"), ("desc", "desc"), ("kvalid", "valid"),
        ("count", "count"))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _matcher_arrays(matcher, p: str) -> Tuple[dict, dict]:
    """(meta, arrays) of a `KeyframeMatcher` under prefix `p`: the used
    slots of the slot buffer, every keyframe's 3D points, the generator
    state, and the JAX package's PRNG key of the matcher's seed."""
    arrays = {f"{p}_key": np.asarray([0, matcher.seed], np.uint32),
              f"{p}_gen_state": matcher.generator_state().numpy()}
    n = len(matcher.stored)
    if n:
        kps = matcher._slots
        for key, field in _KPS:
            arrays[f"{p}_{key}"] = _host(getattr(kps, field)[:n])
        arrays[f"{p}_pts3d"] = np.stack([_host(s.pts3d) for s in matcher.stored])
        arrays[f"{p}_pvalid"] = np.stack([_host(s.pts_valid) for s in matcher.stored])
    return {"gen_device": matcher.device.type}, arrays


def _restore_matcher(matcher, data: dict, p: str, n: int, gen_device: Optional[str]) -> None:
    """Refill a fresh matcher with `n` stored keyframes (each array read
    once) and continue its generator where the file's left off, when the
    file has that generator's state for this device type."""
    from rgbd_odometry_tpu_torch.ops import features as feat

    dev = matcher.device
    put = lambda a: torch.from_numpy(np.array(a, order="C")).to(dev)  # noqa: E731
    if n:
        kps = feat.Keypoints(**{field: put(data[f"{p}_{key}"]) for key, field in _KPS})
        matcher.restore_store(kps, put(data[f"{p}_pts3d"]), put(data[f"{p}_pvalid"]))
    if f"{p}_gen_state" in data and gen_device == dev.type:
        matcher.set_generator_state(torch.from_numpy(np.array(data[f"{p}_gen_state"])))
    elif f"{p}_gen_state" in data:
        print(f"checkpoint: the {p} generator was written on {gen_device}; on {dev.type} it "
              "restarts from its seed", file=sys.stderr)


class Snapshot(NamedTuple):
    """A checkpoint file read once: its `__meta__` and every array."""

    path: str
    meta: dict
    data: dict


def read_checkpoint(path: str) -> Snapshot:
    """The file at `path`, every array decompressed once."""
    with np.load(path, allow_pickle=False) as npz:
        data = {k: npz[k] for k in npz.files}
    return Snapshot(path, json.loads(str(data.pop("__meta__"))), data)


def _snapshot(src: Union[str, Snapshot]) -> Snapshot:
    return src if isinstance(src, Snapshot) else read_checkpoint(src)


def jax_gaps(meta: dict) -> List[str]:
    """For a JAX-written file (it lacks `bad_streak`, which the port always
    writes), the port's keys it lacks, each as the JAX behaviour the resume
    then has; [] for the port's files."""
    if "bad_streak" in meta:
        return []
    gaps = ["the lost-frame streak resumes at 0"]
    for key, what in (("reloc", "relocalizer"), ("closer", "loop closer")):
        if key in meta:
            gaps.append(f"the {what}'s RANSAC draws restart from its seed")
    if "closer" in meta:
        gaps += ["the loop closer takes the caller's configuration",
                 "online refinement's closure baseline is the restored closure count"]
    return gaps


def save_odometry(
    odo: "EdgeDvoOdometry",
    path: str,
    closer: Optional["LoopCloser"] = None,
    raw_rels: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None,
    refine_state: Optional[dict] = None,
) -> None:
    """Snapshot an `EdgeDvoOdometry` (and, optionally, the `dvo` command's
    `LoopCloser`, its raw odometry chain and its online-refinement state
    {"kf", "closures"}) to `path` (.npz)."""
    st = odo.checkpoint_state()
    els = odo.gop.elements
    meta = {
        "frame_num": st["frame_num"],
        "last_ref_frame": st["last_ref_frame"],
        "num_levels": odo.cfg.pyramid.num_levels,
        "config": odo.cfg.to_json(),
        "gop": [{"frame_num": e.frame_num, "is_keyframe": e.is_keyframe, "reason": e.reason,
                 "timestamp": e.timestamp} for e in els],
        "bad_streak": st["bad_streak"],
    }
    arrays = {
        "rel_R": st["R"], "rel_t": st["t"],
        "gop_R": np.stack([e.R for e in els]) if els else np.zeros((0, 3, 3)),
        "gop_t": np.stack([e.t for e in els]) if els else np.zeros((0, 3)),
        "last_key_R": odo.gop.last_key_R, "last_key_t": odo.gop.last_key_t,
    }
    if st["prev_pose"] is not None:
        arrays["prev_rel_R"], arrays["prev_rel_t"] = st["prev_pose"]
    if st["ref_feats"] is not None:
        for lvl, f in enumerate(st["ref_feats"]):
            for name in ("pts3d", "uv", "valid", "count"):
                arrays[f"ref{lvl}_{name}"] = getattr(f, name)
    if st["prev_pyr"] is not None:
        for lvl, (g, d) in enumerate(zip(*st["prev_pyr"])):
            arrays[f"prev_gray{lvl}"], arrays[f"prev_depth{lvl}"] = g, d
    reloc = odo._reloc
    if reloc is not None:
        m, a = _matcher_arrays(reloc.matcher, "reloc")
        meta["reloc"] = {"n": len(reloc.poses),
                         "nodes": [-1 if x is None else int(x) for x in reloc.nodes],
                         "attempts": reloc.attempts, "successes": reloc.successes, **m}
        arrays.update(a)
        if reloc.poses:
            arrays["reloc_pose_R"] = np.stack([q[0] for q in reloc.poses])
            arrays["reloc_pose_t"] = np.stack([q[1] for q in reloc.poses])
    if closer is not None:
        m, a = _matcher_arrays(closer.matcher, "lc")
        meta["closer"] = {
            "n": len(closer.keyframes),
            "nodes": [int(k.node) for k in closer.keyframes],
            "skipped": closer.skipped_candidates,
            "closures": [[int(c[0]), int(c[1]), int(c[4])] for c in closer.closures],
            "config": dataclasses.asdict(closer.cfg), **m,
        }
        arrays.update(a)
        if closer.closures:
            for key, i in (("lc_closure_R", 2), ("lc_closure_t", 3)):
                arrays[key] = np.stack([np.asarray(c[i], np.float64) for c in closer.closures])
        if refine_state is not None:
            meta["refine_state"] = {"kf": int(refine_state["kf"]),
                                    "closures": int(refine_state["closures"])}
    if raw_rels is not None:
        meta["n_raw_rels"] = len(raw_rels)
        if raw_rels:
            arrays["raw_rel_R"] = np.stack([np.asarray(r, np.float64) for r, _ in raw_rels])
            arrays["raw_rel_t"] = np.stack([np.asarray(t, np.float64) for _, t in raw_rels])
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_odometry(src: Union[str, Snapshot], device=None) -> "EdgeDvoOdometry":
    """Restore an `EdgeDvoOdometry` from a checkpoint (a path or a
    `Snapshot`) on `device` (default: the current CUDA device); continue
    with `process_frame`. The relocalizer's
    database comes back too, when the saved configuration enables it; the
    loop closer is restored separately (`load_loop_closer`)."""
    from rgbd_odometry_tpu_torch.config import PipelineConfig
    from rgbd_odometry_tpu_torch.kernels.extract import RefLevel
    from rgbd_odometry_tpu_torch.pipeline.gop import GopElement
    from rgbd_odometry_tpu_torch.pipeline.odometry import EdgeDvoOdometry

    path, meta, data = _snapshot(src)
    odo = EdgeDvoOdometry(PipelineConfig.from_json(meta["config"]), device=device)
    gaps = jax_gaps(meta)
    if gaps:
        print(f"checkpoint {path} was written by the JAX package: " + "; ".join(gaps),
              file=sys.stderr)
    n_levels = int(meta["num_levels"])
    gop = odo.gop
    gop.last_key_R, gop.last_key_t = data["last_key_R"], data["last_key_t"]
    gop_R, gop_t = data["gop_R"], data["gop_t"]
    for i, e in enumerate(meta["gop"]):
        gop.elements.append(GopElement(frame_num=e["frame_num"], is_keyframe=e["is_keyframe"],
                                       reason=e["reason"], R=gop_R[i], t=gop_t[i],
                                       timestamp=e["timestamp"]))
    kf_idx = gop.keyframe_indices()
    gop.last_key_index = kf_idx[-1] if kf_idx else -1
    feats = None
    if "ref0_pts3d" in data:
        feats = tuple(RefLevel(*(data[f"ref{lvl}_{name}"]
                                 for name in ("pts3d", "uv", "valid", "count")))
                      for lvl in range(n_levels))
    prev_pyr = None
    if "prev_gray0" in data:
        prev_pyr = (tuple(data[f"prev_gray{lvl}"] for lvl in range(n_levels)),
                    tuple(data[f"prev_depth{lvl}"] for lvl in range(n_levels)))
    odo.restore_checkpoint_state(
        frame_num=meta["frame_num"], last_ref_frame=meta["last_ref_frame"], R=data["rel_R"],
        t=data["rel_t"],
        prev_pose=(data["prev_rel_R"], data["prev_rel_t"]) if "prev_rel_R" in data else None,
        bad_streak=meta.get("bad_streak", 0), ref_feats=feats, prev_pyr=prev_pyr)
    if odo._reloc is not None and "reloc" in meta:
        rm, reloc = meta["reloc"], odo._reloc
        _restore_matcher(reloc.matcher, data, "reloc", rm["n"], rm.get("gen_device"))
        if rm["n"]:
            reloc.poses = [(data["reloc_pose_R"][s].copy(), data["reloc_pose_t"][s].copy())
                           for s in range(rm["n"])]
        reloc.nodes = [None if x < 0 else x for x in rm["nodes"]]
        reloc.attempts, reloc.successes = int(rm["attempts"]), int(rm["successes"])
    return odo


def load_loop_closer(src: Union[str, Snapshot], intr, config=None,
                     device=None) -> Optional["LoopCloser"]:
    """Restore the `LoopCloser` saved beside an odometry snapshot (None when
    it was saved without one). The closer gets the saved configuration, or
    `config` (which must then equal the saved one, if the file has it; a
    JAX-written file has none and takes `config` or the default)."""
    from rgbd_odometry_tpu_torch.pipeline.loop_closure import (
        KeyframeRecord, LoopCloser, LoopClosureConfig,
    )

    path, meta, data = _snapshot(src)
    if "closer" not in meta:
        return None
    cm = meta["closer"]
    saved = cm.get("config")
    if saved is not None and config is not None and dataclasses.asdict(config) != saved:
        raise ValueError(f"{path}: the loop closer was saved with {saved}, not {config}")
    if saved is not None and config is None:
        config = LoopClosureConfig(**saved)
    closer = LoopCloser(intr, config, device=device)
    _restore_matcher(closer.matcher, data, "lc", cm["n"], cm.get("gen_device"))
    closer.keyframes = [KeyframeRecord(node=cm["nodes"][s], pts3d=p.pts3d, pts_valid=p.pts_valid)
                        for s, p in enumerate(closer.matcher.stored)]
    closer.skipped_candidates = int(cm["skipped"])
    if cm["closures"]:
        cR, ct = data["lc_closure_R"], data["lc_closure_t"]
        closer.closures = [(ni, nj, cR[k], ct[k], inl)
                           for k, (ni, nj, inl) in enumerate(cm["closures"])]
    return closer


def load_raw_rels(src: Union[str, Snapshot]) -> Optional[List[Tuple[np.ndarray, np.ndarray]]]:
    """The raw odometry chain saved beside a snapshot (None when it was saved
    without one)."""
    _, meta, data = _snapshot(src)
    if not meta.get("n_raw_rels"):
        return None if "n_raw_rels" not in meta else []
    R, t, n = data["raw_rel_R"], data["raw_rel_t"], int(meta["n_raw_rels"])
    return [(R[i], t[i]) for i in range(n)]


def load_refine_state(src: Union[str, Snapshot], n_closures: int) -> dict:
    """The online refinement's {"kf", "closures"} at the checkpoint; a file
    without it (JAX) gives the JAX command's: kf 0 and the restored closure
    count as the baseline."""
    return dict(_snapshot(src).meta.get("refine_state", {"kf": 0, "closures": n_closures}))
