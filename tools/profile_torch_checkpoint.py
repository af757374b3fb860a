#!/usr/bin/env python3
"""Where the time of one checkpoint of the resilient_train cell goes, on
one GPU.

    python3 tools/profile_torch_checkpoint.py [--dir DIR] [--reps N]

Builds `chip_smoke.py`'s resilient_train cell (`chip_smoke.
resilient_model()`: full gpt3-125m in bf16, AdamW with fp32 moments,
ScanTrainStep(scan_steps=2)), runs one chunk so the moments exist, and
times each piece of the checkpoint protocol on its state, each the median
of N repetitions (default 3):

- the device→host fetch: one pageable synchronous copy a tensor
  (`.to("cpu")`) beside `checkpoint._host_copy` (pinned copies, one
  synchronisation: what `AsyncCheckpointManager.snapshot` blocks on),
  its first call (which allocates the pinned blocks) apart;
- `framework_io._pack` of the host copy (bf16 written as fp32 values);
- `pickle.dump` (protocol 4, `framework_io.save`'s) of the packed tree
  into a file under DIR (the page cache), then `os.fsync` of it, then
  `checkpoint._file_crc` of it (the JAX package's three passes); and
  `checkpoint._write_step_file` (pack, protocol 5, the CRC counted while
  writing, fsync: what a save does);
- a whole `CheckpointManager.save` into an empty directory and into one
  that already keeps two steps (its retention pass verifies every kept
  step's CRC), `verify`, and `restore` (unpickle and copy to the card);
- the disk alone: the same number of bytes of zeros written and fsynced.

DIR defaults to a new temporary directory (removed at the end). Prints
JSON lines: the card (name and power limit from nvidia-smi), then the
readings in ms and GB/s with the file's size.
"""
import argparse
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def timed(fn, reps):
    """(median seconds, last result) of `reps` calls of fn()."""
    out, times = None, []
    for _ in range(reps):
        out = None       # the last result's memory is free for this call
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=None)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_checkpoint: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch import checkpoint as ck
    from paddle_tpu_torch.framework_io import _pack

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    model, opt, step = cs.resilient_model()
    ids, labels = cs.resilient_batches(model.config.vocab_size)
    step(ids[:2], labels[:2])
    torch.cuda.synchronize()
    state = {"model": model.state_dict(), "opt": opt.state_dict(),
             "step": step._step_count}
    n_bytes = sum(t.numel() * t.element_size() for t in
                  (v for _, v in ck._leaves_with_path(state))
                  if torch.is_tensor(t))
    root = args.dir or tempfile.mkdtemp(prefix="pdtt_ckpt_profile_")
    os.makedirs(root, exist_ok=True)
    reps = args.reps
    r = {"state_bytes": n_bytes, "tensors": sum(
        torch.is_tensor(v) for _, v in ck._leaves_with_path(state))}

    def pageable():
        return {k: (v.detach().to("cpu") if torch.is_tensor(v) else v)
                for k, v in ck._leaves_with_path(state)}

    r["fetch_pageable_s"], _ = timed(pageable, reps)
    # the first pinned fetch allocates the pinned blocks; later ones reuse
    # them from torch's caching host allocator
    r["fetch_pinned_first_s"], _ = timed(lambda: ck._host_copy(state), 1)
    r["fetch_pinned_s"], host = timed(lambda: ck._host_copy(state), reps)
    r["pack_s"], packed = timed(lambda: _pack(host), reps)
    path = os.path.join(root, "piece.pdckpt")

    def dump():
        with open(path, "wb") as f:
            pickle.dump(packed, f, protocol=4)

    r["pickle_dump_s"], _ = timed(dump, reps)
    r["file_bytes"] = os.path.getsize(path)
    def fsync():
        with open(path, "rb") as f:
            os.fsync(f.fileno())

    r["fsync_s"], _ = timed(fsync, 1)
    r["crc_s"], _ = timed(lambda: ck._file_crc(path), reps)
    os.remove(path)
    r["write_step_file_s"], _ = timed(
        lambda: ck._write_step_file(host, path), reps)
    os.remove(path)

    def zeros():
        block = bytes(1 << 26)
        with open(path, "wb") as f:
            for _ in range(r["file_bytes"] // len(block)):
                f.write(block)
            f.flush()
            os.fsync(f.fileno())

    r["disk_write_fsync_s"], _ = timed(zeros, 1)
    os.remove(path)
    mgr = ck.CheckpointManager(os.path.join(root, "mgr"), max_to_keep=2)
    r["save_first_s"], _ = timed(lambda: mgr.save(1, state), 1)
    mgr.save(2, state)
    r["save_keeping_two_s"], _ = timed(lambda: mgr.save(3, state), 1)
    r["verify_s"], _ = timed(lambda: mgr.verify(3), reps)
    r["restore_s"], _ = timed(lambda: mgr.restore(3), 1)
    shutil.rmtree(root, ignore_errors=True)
    for k in list(r):
        if k.endswith("_s") and r[k]:
            base = r["state_bytes"] if k.startswith("fetch") else \
                r["file_bytes"]
            r[k[:-2] + "_gb_per_s"] = base / r[k] / 1e9
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
