#!/usr/bin/env python3
"""Where the time of the PyTorch port's train step goes, on one GPU.

    python3 tools/profile_torch_training.py [--steps K] [--trace DIR]
        [--cells train,train_recipe,llama_train,train_amp,train_amp_fp16,
                 moe_train,resnet_train]

Trains `chip_smoke.py`'s train cells, one after the other — by default
`train` (AdamW, fp32 moments) and `train_recipe` (recompute, bf16
moments, LR schedule, clip, decay filter); `llama_train`, `train_amp` and
`train_amp_fp16` on request: the same model, optimizer and batch, built
by `chip_smoke.train_workload()` (the strategy cells by
`chip_smoke.amp_train_workload()`, whose step comes from `parallelize()`
and whose chunk of scan_steps micro-steps replaces K) and driven through
`ScanTrainStep` as the smoke's train phases drive them — for a warm-up
chunk of 3 steps, a
plain chunk of K steps (wall time and the host's time per step), and a
chunk of K steps under `torch.profiler`. It prints JSON lines: the card
(name and power limit from nvidia-smi), then for each cell the step's
wall time, the host's time per step, the device-busy time and its ratio
to the wall time, and device time per step by family — flash attention
forward, dq and dk/dv (port kernels), LayerNorm (port kernels), GEMMs of
the layers (cuBLAS), the lm-head + cross-entropy, fused Adam (port
kernel), the rest of the optimizer (the global-norm clip, the beta
powers), and the elementwise rest — and by kernel name. The lm-head + CE
and the optimizer are told apart by profiler ranges put around
`FusedLinearCrossEntropyFn` (GPT), `ParallelCrossEntropy` (Llama: the
cross-entropy alone, its lm-head GEMM counts with the layers') and
`Optimizer.apply_gradients` for the profiled chunk only. An MoE cell
(`moe_train`) also gets three MoE families: the router (gate product,
softmax, top-k, cumulative slot counts), dispatch and combine (the
buffer copy, the gather and the weighted sum) and the experts (the
batched products, their biases and activation). Their forward kernels
are those launched under profiler ranges around `nn/layer/moe.py`'s
`_route`, `_dispatch`/`_combine` and `_experts`; their backward kernels
those of the autograd nodes whose sequence numbers the forward ops under
each range carry. The ResNet cell (`resnet_train`, built by
`chip_smoke.resnet_workload()`: BASELINE config 1, resnet50 in bf16 at
64 x 3 x 224 x 224 with CrossEntropyLoss and AdamW) gets three families
the same way: the convolutions (cuDNN), BatchNorm and the pools, from
ranges around `nn/functional/conv.py`'s `_conv_nd` and the functionals
`batch_norm`, `max_pool2d` and `adaptive_avg_pool2d`. With `--trace` it
writes a chrome trace of each cell there. Needs a GPU; exits 2 without
one.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys

CE_RANGE = "lm_head_ce"
OPT_RANGE = "optimizer"
FUSED_ADAM = "fused Adam (port kernel)"
# the stages whose forward and backward kernels get a family of their
# own: (module, function) -> the range each call runs in
RANGES = {("paddle_tpu_torch.nn.layer.moe", "_route"): "moe_route",
          ("paddle_tpu_torch.nn.layer.moe", "_dispatch"):
              "moe_dispatch_combine",
          ("paddle_tpu_torch.nn.layer.moe", "_combine"):
              "moe_dispatch_combine",
          ("paddle_tpu_torch.nn.layer.moe", "_experts"): "moe_experts",
          ("paddle_tpu_torch.nn.functional.conv", "_conv_nd"): "conv",
          ("paddle_tpu_torch.nn.functional", "batch_norm"): "batch_norm",
          ("paddle_tpu_torch.nn.functional", "max_pool2d"): "pool",
          ("paddle_tpu_torch.nn.functional", "adaptive_avg_pool2d"):
              "pool"}
RANGE_FAMILIES = {
    "moe_route": "MoE route (gate product, softmax, top-k, cumsum)",
    "moe_dispatch_combine": "MoE dispatch and combine (copy, gather, "
                            "weighted sum)",
    "moe_experts": "MoE experts (batched products, biases, activation)",
    "conv": "convolutions, forward and backward (cuDNN)",
    "batch_norm": "BatchNorm, forward and backward",
    "pool": "max and adaptive average pools, forward and backward"}
BACKWARD_NODE = "autograd::engine::evaluate_function"


def emit(obj):
    print(json.dumps(obj), flush=True)


def family(name: str) -> str:
    n = name.lower()
    if "flash_fwd_kernel" in n:
        return "flash attention forward (port kernel)"
    if "flash_bwd_dq" in n:
        return "flash attention dq (port kernel)"
    if "flash_bwd_dkv" in n:
        return "flash attention dk/dv (port kernel)"
    if "layernorm_" in n:
        return "LayerNorm forward and backward (port kernels)"
    if "fused_adam_kernel" in n:
        return FUSED_ADAM
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


def _sequence_numbers(evt, into):
    """Add the autograd sequence numbers of the ops under `evt` that
    launched kernels. An op that launches none (a no-op `aten::to` after
    the node its range made) carries the number of the NEXT node, made
    outside the range, which would pull that node's backward in too."""
    if evt.sequence_nr >= 0 and _kernels_under(evt):
        into.add(evt.sequence_nr)
    for c in evt.cpu_children:
        _sequence_numbers(c, into)


def ranged_kernels(events):
    """{range: [(kernel name, device us)]} of a profiled chunk: the
    kernels launched under each range of RANGE_FAMILIES in the forward,
    and those of the backward nodes of the ops launched there."""
    from torch.autograd import DeviceType
    out, seqs = {}, {}
    for e in events:
        # the host-side range only: the profiler also records a
        # device-side annotation under the range's name
        if e.name in RANGE_FAMILIES and e.device_type == DeviceType.CPU:
            out.setdefault(e.name, []).extend(_kernels_under(e))
            _sequence_numbers(e, seqs.setdefault(e.name, set()))
    for e in events:
        if e.name.startswith(BACKWARD_NODE):
            for label, nrs in seqs.items():
                if e.sequence_nr in nrs:
                    out[label].extend(_kernels_under(e))
    return out


def profile_cell(cell, K, trace):
    """Warm up, time and profile one train cell of chip_smoke.py; emit
    its lines. Returns 1 when the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from paddle_tpu_torch.distributed.meta_parallel import \
        ParallelCrossEntropy
    from paddle_tpu_torch.ops.softmax_ce import FusedLinearCrossEntropyFn
    from paddle_tpu_torch.optimizer.optimizer import Optimizer
    from paddle_tpu_torch.parallel import ScanTrainStep

    if cell in chip_smoke.AMP_TRAIN_CELLS:
        # the strategy cells: their parallelize()d ScanTrainStep, whose
        # chunk (scan_steps micro-steps) sets K
        model, opt, step, ids, labels = chip_smoke.amp_train_workload(cell)
        warm, K = step, step.scan_steps
    elif cell == "resnet_train":
        model, opt, ce, ids, labels, _, _ = chip_smoke.resnet_workload()
        warm = ScanTrainStep(model, opt,
                             scan_steps=chip_smoke.TRAIN_WARMUP_STEPS,
                             loss_fn=ce)
        step = ScanTrainStep(model, opt, scan_steps=K, loss_fn=ce)
    else:
        model, opt, ids, labels, _ = chip_smoke.train_workload(cell)
        warm = ScanTrainStep(model, opt,
                             scan_steps=chip_smoke.TRAIN_WARMUP_STEPS)
        step = ScanTrainStep(model, opt, scan_steps=K)

    chip_smoke.timed_chunk(warm, ids, labels)
    # the host's time per step is chip_smoke.timed_chunk's: each step's
    # Python, from its first launch to its last
    _, wall_s, _, host_ms = chip_smoke.timed_chunk(step, ids, labels)
    plain_ms = wall_s * 1e3

    saved = (FusedLinearCrossEntropyFn.forward,
             FusedLinearCrossEntropyFn.backward, Optimizer.apply_gradients,
             ParallelCrossEntropy.forward)
    FusedLinearCrossEntropyFn.forward = staticmethod(
        _ranged(saved[0], CE_RANGE))
    FusedLinearCrossEntropyFn.backward = staticmethod(
        _ranged(saved[1], CE_RANGE))
    Optimizer.apply_gradients = _ranged(saved[2], OPT_RANGE)
    ParallelCrossEntropy.forward = _ranged(saved[3], CE_RANGE)
    saved_ranged = {key: getattr(importlib.import_module(key[0]), key[1])
                    for key in RANGES}
    for (mod, f), label in RANGES.items():
        setattr(importlib.import_module(mod), f,
                _ranged(saved_ranged[(mod, f)], label))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prof_ms = chip_smoke.timed_chunk(step, ids, labels)[1] * 1e3
    finally:
        FusedLinearCrossEntropyFn.forward = staticmethod(saved[0])
        FusedLinearCrossEntropyFn.backward = staticmethod(saved[1])
        Optimizer.apply_gradients = saved[2]
        ParallelCrossEntropy.forward = saved[3]
        for (mod, f), fn in saved_ranged.items():
            setattr(importlib.import_module(mod), f, fn)
    del model, opt, warm, step
    torch.cuda.empty_cache()

    by_name = {}     # kernel name -> device ms over the profiled chunk
    launches = 0
    for e in prof.key_averages():
        # the ranges also appear as device-side annotations spanning
        # their kernels: not kernels, so not counted
        if (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and e.key not in (CE_RANGE, OPT_RANGE, *RANGE_FAMILIES)):
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
    # move the kernels launched under the two ranges into their own rows;
    # fused Adam keeps its own row inside the optimizer's
    ranged = {CE_RANGE: "lm-head + cross-entropy (GEMMs and elementwise)",
              OPT_RANGE: "optimizer without fused Adam (global-norm clip, "
                         "beta powers)"}
    events = prof.events()
    for e in events:
        if e.name in ranged and e.device_type == DeviceType.CPU:
            for kname, us in _kernels_under(e):
                if family(kname) == FUSED_ADAM:
                    continue
                fams[family(kname)] -= us / 1e3
                fams[ranged[e.name]] = fams.get(ranged[e.name], 0.0) \
                    + us / 1e3
    for label, kernels in ranged_kernels(events).items():
        for kname, us in kernels:
            fams[family(kname)] -= us / 1e3
            fams[RANGE_FAMILIES[label]] = fams.get(RANGE_FAMILIES[label],
                                                   0.0) + us / 1e3
    if min(fams.values()) < -1e-3:
        print(f"profile_torch_training: a family's device time is negative "
              f"(a kernel counted in two families): {fams}", file=sys.stderr)
        return 1
    emit({"cell": cell, "phase": "run", "steps": K, "wall_ms": plain_ms,
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
    emit({"cell": cell, "phase": "families", "ms_per_step": {
        k: v / K for k, v in sorted(fams.items(), key=lambda kv: -kv[1])}})
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:20]
    emit({"cell": cell, "phase": "kernels", "ms_per_step": [
        [k[:120], v / K] for k, v in top]})
    if trace:
        os.makedirs(trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace, f"{cell}_steps.json"))
    return 0


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--cells", default="train,train_recipe",
                    help="comma-separated cells of chip_smoke.TRAIN_CELLS "
                         "or AMP_TRAIN_CELLS, or resnet_train")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_training: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    emit({"device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi.stdout.strip()})
    for cell in args.cells.split(","):
        if profile_cell(cell, args.steps, args.trace):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
