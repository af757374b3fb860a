#!/usr/bin/env python3
"""Where `chip_smoke.py`'s mobilenet_fit cell spends its host time, on
one GPU: the `io.DataLoader` alone, and beside `Model.train_batch`.

    python3 tools/profile_torch_loader.py [--images 1024]

Runs from the root of a checkout on a machine with a CUDA card, on the
cell of `chip_smoke.py` (SeededImages through ToTensor and Normalize,
batch 64 at 224 x 224, full mobilenet_v2 in fp32 with Adam). Prints one
JSON line a reading:

- `transform`: ms an image of the transform in the main process, and ms
  a batch of the numpy collation and of copying it to pinned memory;
- `transfer`: ms for one batch's bytes (36.75 MB) to come back from a
  forked worker, pickled through the pool's pipe and through a
  shared-memory block (`io`'s transport: copied into pinned memory and
  unlinked in the main process);
- `loader`: for num_workers 0, 2 and 4 (and 4 with the uint8 images
  untransformed, 4x fewer bytes a batch), the ms to the first batch (the
  pool's start included) and the ms a batch after it, the loader alone;
- `train`: ms a step of train_batch on one batch already on the card,
  then fed by the loader at num_workers 0 and 4, with the main thread's
  ms a step inside `next()` and inside `train_batch`.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def emit(obj):
    print(json.dumps(obj), flush=True)


def _identity(img):
    return img


def _pipe_batch(nbytes):
    import numpy as np
    return np.ones(nbytes // 4, np.float32)


def _shm_batch(nbytes, prefix):
    import numpy as np
    from paddle_tpu_torch.io import _to_shm
    return _to_shm(np.ones(nbytes // 4, np.float32), prefix, [])


def transfer_readings(nbytes, reps=5):
    """Median ms of a batch of `nbytes` from one forked worker: pickled
    through the pipe, and through shared memory."""
    import multiprocessing as mp
    from paddle_tpu_torch.io import _from_shm
    pool = mp.get_context("fork").Pool(1)
    try:
        pool.apply(_pipe_batch, (1024,))
        pipe, shm = [], []
        for i in range(reps):
            t0 = time.perf_counter()
            pool.apply(_pipe_batch, (nbytes,))
            pipe.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            _from_shm(pool.apply(_shm_batch, (nbytes, f"pdtt_probe_{i}")),
                      True, True)
            shm.append((time.perf_counter() - t0) * 1e3)
    finally:
        pool.terminate()
        pool.join()
    return statistics.median(pipe), statistics.median(shm)


def loader_readings(dataset, batch, workers):
    """(ms to the first batch, [ms of each later batch]) of one pass."""
    from paddle_tpu_torch.io import DataLoader
    t0 = time.perf_counter()
    it = iter(DataLoader(dataset, batch_size=batch, num_workers=workers))
    next(it)
    first = (time.perf_counter() - t0) * 1e3
    per = []
    while True:
        t = time.perf_counter()
        try:
            next(it)
        except StopIteration:
            break
        per.append((time.perf_counter() - t) * 1e3)
    return first, per


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=1024)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_loader: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import paddle_tpu_torch
    from paddle_tpu_torch.io import DataLoader, collate_numpy, to_tensors
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.models import mobilenet_v2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = cs.MOBILENET_FIT
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    tf = T.Compose([T.ToTensor(), T.Normalize(cs.IMAGENET_MEAN,
                                              cs.IMAGENET_STD)])
    ds = cs.SeededImages(args.images, cs.SEED + 40, c["side"],
                         c["classes"], tf)
    raw = cs.SeededImages(args.images, cs.SEED + 40, c["side"],
                          c["classes"], _identity)
    B = c["batch"]
    t0 = time.perf_counter()
    samples = [ds[i] for i in range(B)]
    per_image = (time.perf_counter() - t0) * 1e3 / B
    t0 = time.perf_counter()
    stacked = collate_numpy(samples)
    collate = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    to_tensors(stacked, pin=True)
    pin = (time.perf_counter() - t0) * 1e3
    emit({"reading": "transform", "card": smi, "cpus": os.cpu_count(),
          "transform_ms_per_image": per_image,
          "collate_ms_per_batch": collate, "pin_ms_per_batch": pin,
          "batch_mb": stacked[0].nbytes / 2**20})
    pipe, shm = transfer_readings(stacked[0].nbytes)
    emit({"reading": "transfer", "batch_mb": stacked[0].nbytes / 2**20,
          "pipe_ms": pipe, "shared_memory_ms": shm})

    for workers, data, payload in ((0, ds, "fp32"), (2, ds, "fp32"),
                                   (4, ds, "fp32"), (4, raw, "uint8")):
        first, per = loader_readings(data, B, workers)
        emit({"reading": "loader", "num_workers": workers,
              "payload": payload, "first_batch_ms": first,
              "batch_ms_median": statistics.median(per),
              "batch_ms_mean": statistics.mean(per), "batches": len(per)})

    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 43)
    net = mobilenet_v2(num_classes=c["classes"], device="cuda",
                       generator=gen)
    model = paddle_tpu_torch.Model(net).prepare(
        Adam(learning_rate=c["lr"], parameters=net.parameters()),
        CrossEntropyLoss(), Accuracy(topk=(1, 5)))
    x = torch.from_numpy(np.stack([s[0] for s in samples])).cuda()
    y = torch.from_numpy(np.stack([s[1] for s in samples])).cuda()
    for _ in range(3):
        model.train_batch([x], [y])
    steps = []
    for _ in range(10):
        t0 = time.perf_counter()
        model.train_batch([x], [y])
        steps.append((time.perf_counter() - t0) * 1e3)
    emit({"reading": "train", "fed": "one batch on the card",
          "step_ms_median": statistics.median(steps),
          "step_ms_mean": statistics.mean(steps)})
    for workers in (0, 4):
        it = iter(DataLoader(ds, batch_size=B, shuffle=True,
                             num_workers=workers))
        next(it)
        wait, step = [], []
        while True:
            t0 = time.perf_counter()
            try:
                xb, yb = next(it)
            except StopIteration:
                break
            t1 = time.perf_counter()
            model.train_batch([xb], [yb])
            t2 = time.perf_counter()
            wait.append((t1 - t0) * 1e3)
            step.append((t2 - t1) * 1e3)
        emit({"reading": "train", "fed": f"DataLoader num_workers "
                                        f"{workers}",
              "steps": len(step),
              "next_ms_median": statistics.median(wait),
              "train_batch_ms_median": statistics.median(step),
              "step_wall_ms_mean": statistics.mean(
                  [a + b for a, b in zip(wait, step)]),
              "images_per_s": B * len(step) / (sum(wait) + sum(step))
              * 1e3})
    return 0


if __name__ == "__main__":
    sys.exit(main())
