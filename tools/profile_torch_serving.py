#!/usr/bin/env python3
"""Where the time of the PyTorch port's served path goes, on one GPU.

    python3 tools/profile_torch_serving.py [--trace DIR] [--cell CELL]

Serves a serve cell of `chip_smoke.py` (`serve` by default; `llama_serve`,
`llama_serve_gqa`) — the same model, engine and requests, built by
`chip_smoke.serve_workload(cell)` and driven through the
engine's scheduler thread (`start()`) as the serve phase drives them —
three times: twice plain, for the wall time, and once under
`torch.profiler`. It prints JSON lines: the card (name and power limit
from nvidia-smi), steps and wall time, the host's time to enqueue one
step's forward, the device-busy time and its ratio to the wall time, and
device time by kernel family (the port's two CUDA kernels, GEMMs, and the
rest) and by kernel name. With `--trace` it writes a chrome trace there.
Needs a GPU; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def emit(obj):
    print(json.dumps(obj), flush=True)


def family(name: str) -> str:
    n = name.lower()
    if "paged_attention_kernel" in n:
        return "paged_attention (port kernel)"
    if "layernorm_fwd_kernel" in n:
        return "layernorm_fwd (port kernel)"
    if any(t in n for t in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "gemm (cuBLAS)"
    if "index" in n or "scatter" in n or "gather" in n:
        return "index/gather (KV writes, embeddings)"
    if "softmax" in n or "argmax" in n or "reduce" in n:
        return "softmax/argmax/reductions"
    return "elementwise and other"


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None)
    ap.add_argument("--cell", default="serve",
                    help="a cell of chip_smoke.SERVE_CELLS")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    emit({"device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi.stdout.strip()})
    _, engine, prompts, _ = chip_smoke.serve_workload(args.cell)

    # host time to enqueue one step's forward, on the scheduler thread:
    # nothing in the forward waits for the device (the step's only sync is
    # the selection's copy back), so this is the host's share of a step
    enqueue_ms = []
    step_logits = engine._step_logits

    def timed_step_logits(*a):
        t = time.perf_counter()
        out = step_logits(*a)
        enqueue_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def serve():
        """(wall ms, steps, decode steps) of one burst of the workload."""
        _, _, wall, steps, decode_steps = chip_smoke.serve_burst(engine,
                                                                 prompts)
        torch.cuda.synchronize()
        return wall * 1e3, steps, decode_steps

    engine.start()
    try:
        chip_smoke.serve_warm_up(engine, prompts)
        # two plain bursts: the first can still pay one-time costs (clocks
        # ramping from idle, allocator growth); the second is the wall time
        first_ms, _, _ = serve()
        engine._step_logits = timed_step_logits
        plain_ms, steps, decode_steps = serve()
        engine._step_logits = step_logits
        # CUPTI records every kernel of the process, whichever thread
        # launched it
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prof_ms, _, _ = serve()
    finally:
        engine.stop(drain=True, timeout=60)
    by_name = {}    # kernel name -> device ms over the profiled burst
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by_name[e.key] = (by_name.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3)
    if not by_name:
        print("profile_torch_serving: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    busy_ms = sum(by_name.values())
    fams = {}
    for k, v in by_name.items():
        fams[family(k)] = fams.get(family(k), 0.0) + v
    emit({"phase": "run", "cell": args.cell, "requests": len(prompts),
          "steps": steps,
          "decode_steps": decode_steps, "wall_ms_first_pass": first_ms,
          "wall_ms": plain_ms,
          "step_ms": plain_ms / steps,
          "host_enqueue_ms_per_step_p50": statistics.median(enqueue_ms),
          "wall_ms_profiled": prof_ms,
          "device_busy_ms": busy_ms,
          "device_busy_ms_per_step": busy_ms / steps,
          # raw ratios, unclamped: a ratio above 1 would mean the busy sum
          # counts overlapping kernels or the windows differ
          "device_busy_over_wall_profiled": busy_ms / prof_ms,
          # the profiler slows the host, not the device: the same busy
          # time over the unprofiled burst's wall time
          "device_busy_over_wall_unprofiled": busy_ms / plain_ms})
    emit({"phase": "families", "ms_per_step": {
        k: v / steps for k, v in sorted(fams.items(),
                                        key=lambda kv: -kv[1])}})
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    emit({"phase": "kernels", "ms_per_step": [
        [k[:120], v / steps] for k, v in top]})
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace,
                                              "serving_steps.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
