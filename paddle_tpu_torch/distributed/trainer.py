"""Dataset-driven trainer run loops (counterpart of
paddle_tpu/distributed/trainer.py).

Reference: paddle/fluid/framework/trainer.h:57 (MultiTrainer — one
device-worker thread per device pulling from DataFeed) and
device_worker.h:150 (HogwildWorker run loop), driven by
Executor.train_from_dataset (executor.py:1802).

One process drives the card, so the reference's thread-per-device fan-out
is a single host loop that keeps the device fed: an `io.ChunkPrefetcher`
stacks and stages the next chunk on its thread while the current one
computes, and the train step's launches run asynchronously on the card.
"""
from __future__ import annotations

import sys
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch


def _host_losses(loss) -> np.ndarray:
    """A step's loss (a tensor, numpy array or float) as a 1-d numpy
    array; reading a device tensor waits for the work that makes it."""
    if torch.is_tensor(loss):
        loss = loss.detach().float().cpu().numpy()
    return np.atleast_1d(np.asarray(loss))


class DeviceWorker:
    """HogwildWorker analog: runs the train fn over a batch stream."""

    def __init__(self, train_fn: Callable, print_period: int = 100):
        self.train_fn = train_fn
        self.print_period = print_period
        self.steps = 0
        self.last_loss = None
        # a scan-fused step (parallel.ScanTrainStep) eats [K, ...] chunks
        # and returns the per-step loss vector; the run loop then advances
        # K steps per call and reports losses step-by-step
        self.scan_steps = int(getattr(train_fn, "scan_steps", 1) or 1)
        from ..profiler import ThroughputTracker
        self.throughput = ThroughputTracker()
        # goodput ledger (obs.goodput.GoodputLedger) — None keeps every
        # hook below at exactly one predicate. `ledger_phase` is what the
        # NEXT dispatch's device time books as: the resilient trainer
        # flips it to "rollback_waste" while re-running rolled-back steps
        self.ledger = None
        self.ledger_phase = "compute"

    def run_step(self, batch):
        """One step: unpack the batch, run the train fn, track the loss.
        Step-level drivers (ResilientTrainer) call this directly so they
        can checkpoint/retry/rollback between steps. Over a scan-fused
        step this is one CHUNK: K steps advance and K losses report."""
        args = batch if isinstance(batch, (tuple, list)) else (batch,)
        if self.scan_steps > 1:
            return self._run_chunk(args)
        if self.ledger is not None:
            with self.ledger.measure(self.ledger_phase):
                loss = self.train_fn(*args)
            self.ledger.add_steps(
                1, productive=(self.ledger_phase == "compute"))
        else:
            loss = self.train_fn(*args)
        self.steps += 1
        self.last_loss = loss
        if self.print_period and self.steps % self.print_period == 0:
            if torch.is_tensor(loss):
                val = f"{float(loss.item()):.5f}"
            elif isinstance(loss, (int, float)):
                val = f"{float(loss):.5f}"
            else:  # train fns may return None or (loss, metrics) tuples
                val = repr(loss)
            print(f"[trainer] step {self.steps} loss {val}",
                  file=sys.stderr)
        return loss

    def _run_chunk(self, args):
        """One fused dispatch: K steps on device, per-step loss reporting
        and throughput accounting on the host."""
        t0 = time.perf_counter()
        if self.ledger is not None:
            with self.ledger.measure(self.ledger_phase):
                loss = self.train_fn(*args)
                # reading the loss vector waits for the chunk, so the
                # booked span covers device compute, not the enqueue
                losses = _host_losses(loss)
            self.ledger.add_steps(
                losses.size, productive=(self.ledger_phase == "compute"))
        else:
            loss = self.train_fn(*args)
            losses = _host_losses(loss)
        dt = time.perf_counter() - t0
        self.throughput.update(steps=losses.size, seconds=dt,
                               tokens=self._chunk_tokens(args))
        for v in losses:
            self.steps += 1
            if self.print_period and self.steps % self.print_period == 0:
                print(f"[trainer] step {self.steps} loss {float(v):.5f}",
                      file=sys.stderr)
        self.last_loss = loss
        return loss

    @staticmethod
    def _chunk_tokens(args):
        """Tokens per chunk = element count of the first [K, batch, seq]
        array (the token ids); 0 when no such array is found."""
        for a in args:
            if getattr(a, "ndim", 0) >= 2:
                return int(a.numel() if torch.is_tensor(a) else a.size)
        return 0

    def run(self, batch_iter: Iterable):
        for batch in batch_iter:
            self.run_step(batch)
        return self.last_loss


class MultiTrainer:
    """trainer.h:57 analog: a dataset-driven run loop.

    usage:
        trainer = MultiTrainer(step_fn)         # e.g. a ScanTrainStep
        trainer.train_from_dataset(dataset, epochs=2, batch_decoder=fn)
    dataset: an iterable (io.DataLoader, a generator, a list);
    batch_decoder maps a raw record/batch to the step's arguments.
    """

    def __init__(self, train_fn: Callable, print_period: int = 100):
        self.worker = DeviceWorker(train_fn, print_period)

    def train_from_dataset(self, dataset: Iterable, epochs: int = 1,
                           batch_decoder: Optional[Callable] = None,
                           prefetch: Optional[int] = None):
        """prefetch: when the train fn is scan-fused (scan_steps > 1), wrap
        the per-step batch stream in an io.ChunkPrefetcher of this depth —
        a background thread stacks the next K batches and starts their
        copy to the device while the current chunk computes. None/0 means
        the dataset already yields whatever the step consumes."""
        if prefetch and self.worker.scan_steps <= 1:
            raise ValueError(
                "prefetch requires a scan-fused train fn (scan_steps > 1); "
                "this train fn dispatches one step per batch")
        last = None
        for epoch in range(epochs):
            before = self.worker.steps
            it = iter(dataset)
            if batch_decoder is not None:
                it = (batch_decoder(b) for b in it)
            if prefetch:
                from ..io.prefetch import ChunkPrefetcher
                pf = ChunkPrefetcher(
                    it, scan_steps=self.worker.scan_steps,
                    put_fn=getattr(self.worker.train_fn,
                                   "device_put_chunk", None),
                    depth=int(prefetch))
                try:
                    last = self.worker.run(pf)
                finally:
                    pf.close()
            else:
                last = self.worker.run(it)
            if epochs > 1 and epoch > 0 and self.worker.steps == before:
                raise ValueError(
                    f"dataset yielded no batches in epoch {epoch + 1}: "
                    "one-shot iterators (generators) exhaust after the first "
                    "epoch — pass a re-iterable (list, DataLoader) for "
                    "epochs > 1")
        return last

    @property
    def steps(self):
        return self.worker.steps


def train_from_dataset(train_fn, dataset, epochs=1, batch_decoder=None,
                       print_period=100, prefetch=None):
    """Executor.train_from_dataset parity entry."""
    return MultiTrainer(train_fn, print_period).train_from_dataset(
        dataset, epochs, batch_decoder, prefetch=prefetch)
