"""Background-thread chunk prefetcher (counterpart of
paddle_tpu/io/prefetch.py).

`parallel.ScanTrainStep` consumes [K, ...] stacked chunks, K steps a
call; feeding it synchronously would serialize K batch collations and a
host-to-device copy with the chunk's compute. This prefetcher moves that
work onto a background thread: while chunk N computes on the card, the
thread stacks the next K host batches and *starts* their copy (pinned
memory, non-blocking, on the current stream), so the copy overlaps
compute instead of extending the step.

depth=2 is classic double buffering: one chunk in flight on the device,
one staged. Each extra slot pins another chunk of host and device
memory.

usage:
    pf = ChunkPrefetcher(loader, scan_steps=8,
                         put_fn=step.device_put_chunk)
    for chunk in pf:              # tuple of device [K, ...] tensors
        losses = step(*chunk)
"""
from __future__ import annotations

import queue as _queue
import threading
import time
import warnings
from functools import partial
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..core.device import resolve_device


def _put_on(device, stacked):
    """The default put_fn: each array copied to `device` from pinned
    memory, non-blocking."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                 .to(device, non_blocking=True) for a in stacked)


class _Done:
    pass


class _Err:
    def __init__(self, exc):
        self.exc = exc


def _stack(batches):
    """K per-step batches (tuples/lists of arrays or tensors, or bare
    ones) -> tuple of [K, ...] numpy arrays."""

    def as_np(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) \
            else np.asarray(x)

    first = batches[0]
    if isinstance(first, (tuple, list)):
        return tuple(np.stack([as_np(b[j]) for b in batches])
                     for j in range(len(first)))
    return (np.stack([as_np(b) for b in batches]),)


class ChunkPrefetcher:
    """Background-thread chunk stacker + async H2D stager.

    source: iterable of per-step batches (what a DataLoader yields).
    scan_steps: K — batches per fused chunk.
    put_fn: tuple of stacked numpy arrays -> device tensors. Pass the
        runner's `device_put_chunk`; the default copies to the first GPU
        (pinned, non-blocking) and raises NoCUDADeviceError at
        construction where there is none.
    depth: max staged chunks (2 = double buffering).

    A trailing partial chunk (< K batches) is DROPPED, as in JAX, whose
    scan has a static trip count; `dropped_steps` records how many
    batches fell off so callers can account for them (no silent
    truncation).

    stall_timeout_s: if the consumer takes nothing for this long while the
    queue is full (iteration abandoned without close() and no context
    manager), the producer gives up and exits instead of busy-polling
    forever with staged device buffers pinned. Raise it when a single
    chunk's device compute can legitimately exceed the default.
    """

    def __init__(self, source: Iterable, scan_steps: int,
                 put_fn: Optional[Callable] = None, depth: int = 2,
                 stall_timeout_s: float = 60.0):
        if scan_steps < 1:
            raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if stall_timeout_s <= 0:
            raise ValueError(
                f"stall_timeout_s must be > 0, got {stall_timeout_s}")
        self.source = source
        self.scan_steps = int(scan_steps)
        self.depth = int(depth)
        self.stall_timeout_s = float(stall_timeout_s)
        if put_fn is None:
            put_fn = partial(_put_on, resolve_device(None))
        self.put_fn = put_fn
        self.dropped_steps = 0
        self.chunks_produced = 0
        self._q: _queue.Queue = _queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    # ---- producer ----
    def _produce(self):
        try:
            it = iter(self.source)
            pending = []
            for batch in it:
                if self._stop.is_set():
                    return
                pending.append(batch)
                if len(pending) < self.scan_steps:
                    continue
                dev = self.put_fn(_stack(pending))  # starts the async H2D
                pending = []
                if not self._bounded_put(dev):
                    return
                self.chunks_produced += 1
            self.dropped_steps = len(pending)
            if pending:
                warnings.warn(
                    f"ChunkPrefetcher dropped a trailing partial chunk of "
                    f"{len(pending)} step(s) (< scan_steps="
                    f"{self.scan_steps})", stacklevel=2)
        except BaseException as e:  # propagate into the consumer
            self._bounded_put(_Err(e))
            return
        self._bounded_put(_Done())

    def _bounded_put(self, item) -> bool:
        """Queue put that can never wedge the producer. Wakes every 100ms so
        close() can join promptly, and — for a consumer that abandoned
        iteration without close() (no context manager) — gives up after
        `stall_timeout_s` of continuous queue-full, dropping the item and
        stopping production so staged device buffers aren't pinned for the
        process lifetime. Returns True iff the item was enqueued."""
        deadline = time.monotonic() + self.stall_timeout_s
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                if time.monotonic() >= deadline:
                    self._stop.set()  # before warn(): filters may raise
                    warnings.warn(
                        f"ChunkPrefetcher consumer took nothing for "
                        f"{self.stall_timeout_s:.0f}s with a full queue; "
                        "assuming iteration was abandoned without close() — "
                        "stopping the producer and dropping staged chunks",
                        stacklevel=2)
                    return False
        return False

    # ---- consumer ----
    def __iter__(self):
        if self._closed:
            return self       # closed: iteration terminates, never restarts
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._produce, daemon=True,
                name="pdtt-chunk-prefetch")
            self._thread.start()
        return self

    def _take(self):
        """Blocking dequeue of the next staged item."""
        while True:
            try:
                return self._q.get(timeout=0.1)
            except _queue.Empty:
                if self._closed:  # closed under us mid-wait
                    raise StopIteration

    def __next__(self):
        if self._closed:
            raise StopIteration
        if self._thread is None:
            iter(self)
        item = self._take()
        if isinstance(item, _Done):
            raise StopIteration
        if isinstance(item, _Err):
            raise item.exc
        return item

    def __enter__(self):
        """Context-manager use guarantees the drain discipline: a consumer
        that raises mid-epoch still joins the producer thread and releases
        every staged (in-flight copy) chunk on the way out."""
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        """Stop the producer thread, join it, and drain staged chunks so
        their device buffers are released. Idempotent; a closed prefetcher
        iterates as exhausted instead of blocking."""
        self._closed = True
        self._stop.set()
        self._drain()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            # the producer may have slipped one last control message in
            # between the drain and its exit — release that too
            self._drain()
            self._thread = None

    def _drain(self):
        try:
            while True:
                self._q.get_nowait()
        except _queue.Empty:
            pass

    def __del__(self):
        try:
            self._stop.set()
        except Exception:
            pass
