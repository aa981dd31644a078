"""Host-side prefetch feeding the device.

Counterpart of ``runet_tpu/data/pipeline.py``. A background thread draws
patch batches with numpy (``sample_batch``) in compact dtypes (f16 images,
uint8 labels; the step upcasts them) into pinned host memory, and queues
them (at most PREFETCH batches). The
consumer thread copies each batch to the device with
``.to(device, non_blocking=True)`` on a copy stream of its own; the
compute stream waits for that copy and the device tensors are recorded on
it. No tensor made on the worker thread is used on the device by any other
stream than that copy.
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Iterator

import numpy as np
import torch

from runet_tpu_torch import resolve_device
from runet_tpu_torch.data.dataset import PreparedCase
from runet_tpu_torch.data.sampler import sample_batch


PREFETCH = 2


class PatchLoader:
    """Infinite iterator of (images (B, X, Y, Z, 1) f16, labels (B, X, Y, Z)
    uint8) batches resident on ``device`` (CUDA unless named)."""

    # Queue sentinel marking a dead worker: the consumer re-raises instead
    # of blocking forever on an empty queue.
    _SENTINEL = object()

    def __init__(
        self,
        cases: list[PreparedCase],
        batch_size: int,
        patch_size: tuple[int, int, int],
        fg_prob: float = 0.5,
        seed: int = 0,
        device=None,
    ):
        self.cases = cases
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.fg_prob = fg_prob
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._rng = np.random.default_rng(seed)
        self._q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        self._stop = threading.Event()
        self._exc: BaseException | None = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            self._worker_loop()
        except BaseException as e:  # handed to the consumer thread
            self._exc = e
            self._put(self._SENTINEL)

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _worker_loop(self):
        while not self._stop.is_set():
            images, labels = sample_batch(
                self._rng, self.cases, self.batch_size, self.patch_size, self.fg_prob,
                image_dtype=np.float16, label_dtype=np.uint8,
            )
            batch = (torch.from_numpy(images), torch.from_numpy(labels))
            if self._cuda:
                batch = tuple(t.pin_memory() for t in batch)
            self._put(batch)

    def __iter__(self) -> Iterator:
        return self

    def _get(self):
        while True:
            try:
                item = self._q.get(timeout=1.0)
            except queue.Empty:
                if self._exc is not None or not self._thread.is_alive():
                    raise RuntimeError("PatchLoader worker thread is dead") from self._exc
                continue
            if item is self._SENTINEL:
                self._exc = self._exc or RuntimeError("worker stopped")
                raise RuntimeError("PatchLoader worker thread failed") from self._exc
            return item

    def __next__(self):
        host = self._get()
        if not self._cuda:
            return tuple(t.to(self.device) for t in host)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            out = tuple(t.to(self.device, non_blocking=True) for t in host)
        compute.wait_stream(self._copy_stream)
        for t in out:
            t.record_stream(compute)
        return out

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
