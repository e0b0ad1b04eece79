"""Asynchronous frame feeder: port of `rgbd_odometry_tpu/pipeline/feeder.py`.

A worker thread takes (gray, depth_mm, timestamp) frames from a source,
builds each frame's pyramid on the host and, for a CUDA device, stages it in
pinned memory and copies it to the card on a CUDA stream of its own, then
records an event. The consumer's stream waits on that event before it uses
the tensors, and each tensor is `record_stream`ed on the consumer's stream,
so the caching allocator never hands its memory to another tensor while the
consumer may still read it. Host decode, pyramid build and the copy thereby
overlap the previous frame's solve. The queue depth is the backpressure:
the worker blocks once `depth` pyramids are staged, and no frame is dropped.
An error in the worker is raised to the consumer at the point it occurred
in the stream.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from rgbd_odometry_tpu_torch.core.pyramid import FramePyramid, build_pyramid
from rgbd_odometry_tpu_torch.device import resolve_device


class FrameFeeder:
    """Prefetching iterator: frames() tuples in, pyramids (batch 1) on
    `device` out, as `(FramePyramid, timestamp)`. `device` defaults to the
    current CUDA device (`resolve_device`); `device="cpu"` keeps the
    pyramids on the host."""

    _SENTINEL = object()

    def __init__(
        self,
        source_iter: Iterator[Tuple[np.ndarray, np.ndarray, float]],
        num_levels: int = 4,
        depth: int = 2,
        device=None,
    ):
        self._source = source_iter
        self._levels = num_levels
        self._device = resolve_device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        cuda = self._device.type == "cuda"
        stream = torch.cuda.Stream(self._device) if cuda else None
        try:
            for gray, depth_mm, ts in self._source:
                pyr = build_pyramid(
                    torch.as_tensor(np.asarray(gray), dtype=torch.float32)[None],
                    torch.as_tensor(np.asarray(depth_mm), dtype=torch.float32)[None],
                    self._levels,
                )
                event = None
                if cuda:
                    with torch.cuda.stream(stream):
                        pyr = FramePyramid(*(
                            tuple(x.pin_memory().to(self._device, non_blocking=True) for x in part)
                            for part in pyr
                        ))
                        event = torch.cuda.Event()
                        event.record(stream)
                self._q.put((pyr, ts, event))
        except BaseException as e:  # surface worker errors to the consumer
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[FramePyramid, float]:
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        pyr, ts, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for part in pyr:
                for x in part:
                    x.record_stream(consumer)
        return pyr, ts
