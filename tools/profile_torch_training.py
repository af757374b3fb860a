#!/usr/bin/env python3
"""Where the time of the PyTorch port's train step goes, on one GPU.

    python3 tools/profile_torch_training.py [--steps K] [--trace DIR]

Trains `chip_smoke.py`'s train cell — the same model, optimizer and
batch, built by `chip_smoke.train_workload()` and driven through
`ScanTrainStep` as the train phase drives them — for a warm-up chunk of
3 steps, a plain chunk of K steps (wall time and the host's time per
step), and a chunk of K steps under `torch.profiler`. It prints JSON
lines: the card (name and power limit from nvidia-smi), the step's wall
time, the host's time per step, the device-busy time and its ratio to the
wall time, and device time per step by family — flash attention forward
and backward (port kernels), LayerNorm (port kernels), GEMMs of the
layers (cuBLAS), the lm-head + cross-entropy, the optimizer (AdamW and
the global-norm clip), and the elementwise rest — and by kernel name.
The lm-head + CE and the optimizer are told apart by profiler ranges
put around `FusedLinearCrossEntropyFn` and `Optimizer.apply_gradients`
for the profiled chunk only. With `--trace` it writes a chrome trace
there. Needs a GPU; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CE_RANGE = "lm_head_ce"
OPT_RANGE = "optimizer"


def emit(obj):
    print(json.dumps(obj), flush=True)


def family(name: str) -> str:
    n = name.lower()
    if "flash_fwd_kernel" in n:
        return "flash attention forward (port kernel)"
    if "flash_bwd_" in n:
        return "flash attention backward (port kernels)"
    if "layernorm_" in n:
        return "LayerNorm forward and backward (port kernels)"
    if any(t in n for t in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "GEMMs of the layers (cuBLAS)"
    return "elementwise and other"


def _ranged(fn, label):
    """fn wrapped in a profiler range named `label`."""
    import torch

    def wrapped(*a, **k):
        with torch.profiler.record_function(label):
            return fn(*a, **k)
    return wrapped


def _kernels_under(evt):
    """[(kernel name, device us)] launched under a profiler event."""
    out = [(k.name, k.duration) for k in evt.kernels]
    for c in evt.cpu_children:
        out += _kernels_under(c)
    return out


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_training: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from paddle_tpu_torch.ops.softmax_ce import FusedLinearCrossEntropyFn
    from paddle_tpu_torch.optimizer.optimizer import Optimizer
    from paddle_tpu_torch.parallel import ScanTrainStep

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    emit({"device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi.stdout.strip()})
    model, opt, ids, labels, _ = chip_smoke.train_workload()
    K = args.steps
    warm = ScanTrainStep(model, opt, scan_steps=chip_smoke.TRAIN_WARMUP_STEPS)
    step = ScanTrainStep(model, opt, scan_steps=K)

    chip_smoke.timed_chunk(warm, ids, labels)
    # the host's time per step is chip_smoke.timed_chunk's: each step's
    # Python, from its first launch to its last
    _, wall_s, _, host_ms = chip_smoke.timed_chunk(step, ids, labels)
    plain_ms = wall_s * 1e3

    saved = (FusedLinearCrossEntropyFn.forward,
             FusedLinearCrossEntropyFn.backward, Optimizer.apply_gradients)
    FusedLinearCrossEntropyFn.forward = staticmethod(
        _ranged(saved[0], CE_RANGE))
    FusedLinearCrossEntropyFn.backward = staticmethod(
        _ranged(saved[1], CE_RANGE))
    Optimizer.apply_gradients = _ranged(saved[2], OPT_RANGE)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prof_ms = chip_smoke.timed_chunk(step, ids, labels)[1] * 1e3
    finally:
        FusedLinearCrossEntropyFn.forward = staticmethod(saved[0])
        FusedLinearCrossEntropyFn.backward = staticmethod(saved[1])
        Optimizer.apply_gradients = saved[2]

    by_name = {}     # kernel name -> device ms over the profiled chunk
    launches = 0
    for e in prof.key_averages():
        # the two ranges also appear as device-side annotations spanning
        # their kernels: not kernels, so not counted
        if (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and e.key not in (CE_RANGE, OPT_RANGE)):
            by_name[e.key] = (by_name.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3)
            launches += e.count
    if not by_name:
        print("profile_torch_training: the profiler recorded no device "
              "time", file=sys.stderr)
        return 1
    busy_ms = sum(by_name.values())
    fams = {}
    for k, v in by_name.items():
        fams[family(k)] = fams.get(family(k), 0.0) + v
    # move the kernels launched under the two ranges into their own rows
    ranged = {CE_RANGE: "lm-head + cross-entropy (GEMMs and elementwise)",
              OPT_RANGE: "optimizer (AdamW and the global-norm clip)"}
    for e in prof.events():
        if e.name in ranged:
            for kname, us in _kernels_under(e):
                fams[family(kname)] -= us / 1e3
                fams[ranged[e.name]] = fams.get(ranged[e.name], 0.0) \
                    + us / 1e3
    emit({"phase": "run", "steps": K, "wall_ms": plain_ms,
          "step_ms": plain_ms / K,
          "host_ms_per_step_p50": statistics.median(host_ms),
          "host_ms_per_step": host_ms,
          "wall_ms_profiled": prof_ms,
          "device_busy_ms": busy_ms,
          "device_busy_ms_per_step": busy_ms / K,
          "kernel_launches_per_step": launches / K,
          # raw ratios, unclamped
          "device_busy_over_wall_profiled": busy_ms / prof_ms,
          "device_busy_over_wall_unprofiled": busy_ms / plain_ms})
    emit({"phase": "families", "ms_per_step": {
        k: v / K for k, v in sorted(fams.items(), key=lambda kv: -kv[1])}})
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:20]
    emit({"phase": "kernels", "ms_per_step": [
        [k[:120], v / K] for k, v in top]})
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace,
                                              "training_steps.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
