#!/usr/bin/env python3
"""Where the time of the PyTorch port's served path goes, on one GPU.

    python3 tools/profile_torch_serving.py [--trace DIR] [--cell CELL]

Serves a serve cell of `chip_smoke.py` (`serve` by default; `llama_serve`,
`llama_serve_gqa`, `sample_serve`) — the same model, engine and requests,
built by `chip_smoke.serve_workload(cell)` and driven through the
engine's scheduler thread (`start()`) as the serve phases drive them
(`sample_serve` with `chip_smoke.sample_burst`'s mix of greedy, sampled
and JSON-constrained requests) — three times: twice plain, for the wall
time, and once under `torch.profiler`. It prints JSON lines: the card
(name and power limit from nvidia-smi), steps and wall time, the host's
time a step (the whole step, enqueueing its forward, enqueueing its
sampled selection), the device-busy time and its ratio to the wall time,
device time by kernel family (the port's two CUDA kernels, GEMMs, and the
rest) and by kernel name, and the host's time by operator. With
`--trace` it writes a chrome trace there. Needs a GPU; exits 2 without
one.
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
    from paddle_tpu_torch.serving.llm import llm_engine

    _, engine, prompts, _ = chip_smoke.serve_workload(args.cell)
    sampled = args.cell == "sample_serve"
    burst = chip_smoke.sample_burst if sampled else chip_smoke.serve_burst
    warm_up = (chip_smoke.sample_warm_up if sampled
               else chip_smoke.serve_warm_up)

    # host time on the scheduler thread: a whole step (_step_once), the
    # enqueue of its forward (nothing in the forward waits for the device;
    # the step's only sync is the selection's copy back) and of its
    # sampled selection (select_rows)
    host_ms = {"step": [], "forward_enqueue": [], "select_enqueue": []}
    originals = (engine._step_once, engine._step_logits,
                 llm_engine.select_rows)

    def timed(fn, key):
        def wrapper(*a):
            t = time.perf_counter()
            out = fn(*a)
            host_ms[key].append((time.perf_counter() - t) * 1e3)
            return out
        return wrapper

    def serve():
        """(wall ms, steps, decode steps) of one burst of the workload."""
        _, _, wall, steps, decode_steps = burst(engine, prompts)
        torch.cuda.synchronize()
        return wall * 1e3, steps, decode_steps

    engine.start()
    try:
        warm_up(engine, prompts)
        # two plain bursts: the first can still pay one-time costs (clocks
        # ramping from idle, allocator growth); the second is the wall time
        first_ms, _, _ = serve()
        engine._step_once = timed(originals[0], "step")
        engine._step_logits = timed(originals[1], "forward_enqueue")
        llm_engine.select_rows = timed(originals[2], "select_enqueue")
        plain_ms, steps, decode_steps = serve()
        engine._step_once, engine._step_logits = originals[:2]
        llm_engine.select_rows = originals[2]
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
          "host_enqueue_ms_per_step_p50": statistics.median(
              host_ms["forward_enqueue"]),
          "host_ms_per_step_p50": {k: statistics.median(v) if v else None
                                   for k, v in host_ms.items()},
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
    # the host's side: operators by self CPU time, with their calls a step
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_cpu_time_total)[:20]
    emit({"phase": "host_ops", "ms_and_calls_per_step": [
        [e.key[:80], e.self_cpu_time_total / 1e3 / steps, e.count / steps]
        for e in ops]})
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace,
                                              "serving_steps.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
