#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`paddle_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100. It
builds the port's CUDA kernels from `paddle_tpu_torch/csrc/`, holds each
one against its plain PyTorch version on the card, checks cut-down models
on the card against the same models on the CPU, serves 16 requests
through the continuous-batching `LLMEngine` and trains 13 steps through
`ScanTrainStep` twice, both at the full width of `gpt3-1.3b` in bf16
(random weights from a seed). It prints one JSON line per phase, then the
`{"kernels": [...]}` line, then the card's name and power limit as
`nvidia-smi` reports them, and last `{"ok": true, "device": {...}}`. Any
failure exits non-zero before the last two lines; with no GPU, or outside
a checkout, it exits 2 at once.

Phases:
  1. device   — card name, count, nvidia-smi name/power limit
  2. build    — nvcc build of the kernel library, timed, with ptxas's
                register and spill report (no instantiation of a
                tensor-core kernel or of a LayerNorm kernel may spill),
                the tensor-core instructions (wgmma's HGMMA, mma.sync's
                HMMA) of every instantiation of the bf16 flash forward, dq
                and dk/dv (plain, mask and dropout) and the bf16 paged
                attention counted in their machine code (cuobjdump -sass),
                and 16-byte loads and stores (LDG.E.128, STG.E.128) in
                every bf16 LayerNorm instantiation of the 16-byte path
  3. kernels  — each kernel against its plain version at its path's
                shapes (serving: paged attention and the LayerNorm
                forward; training: flash attention forward, dq and dk/dv
                at [4,16,1024,128] bf16 causal and the LayerNorm forward
                and backward at 4096x2048 bf16, the forward also with its
                input cycled past L2, and a row's forward bit-equal alone,
                among 64 or 512 rows and at scalar width; the optimizer:
                fused Adam bit for bit in every dtype, with and without a
                master weight, at n = 1000, 2049, linear1.weight and the
                word embedding), with fp32, GQA, block_len 12..64, non-causal,
                Sq != Sk, ragged, D=16..64 and B*H > 132 edge cases, the
                bf16 paged attention and flash forward, dq and dk/dv run
                twice and held bit-equal, timed on the device (median of
                21 CUDA-event samples of back-to-back calls held behind a
                spin kernel) beside one PyTorch library call for the same
                function and the least time the card could take (flash
                and paged attention: with their achieved TFLOP/s and share
                of that bound)
  3d. attention_variants — the additive-mask and dropout variants of the
                flash forward, dq and dk/dv at gpt3-1.3b's attention width
                ([4,16,1024,128] bf16; fp32 at [2,4,256,64]): key padding
                (causal or not), a per-head bf16 mask, a 3-D mask, dropout
                0.1, each against its plain version (the dropout keep-mask
                of the kernels, philox.cuh, against its plain twin bit for
                bit), run twice bit-equal; then driven through
                scaled_dot_product_attention (forward and backward) with
                the launch counts zeroed just before and read just after,
                mask plus dropout taking the plain reference (the JAX
                package's rule) with its mask gradient; timed beside the
                kernels without the variant and F.scaled_dot_product_attention
  4. model    — gpt3-1.3b widths cut to 2 layers, fp32, on the card
                (kernels) against a CPU twin with the same weights (plain
                versions): the engine's unified steps (logits and tokens),
                and twice 3 steps through ScanTrainStep, with AdamW and
                with the train recipe's optimizer and recompute (first-step
                gradient norms, losses, weights)
  5. serve    — full gpt3-1.3b, bf16, LLMEngine(num_slots=8, block_len=8,
                n_blocks=64, prefill_chunk=64) on a MonotonicClock via
                start(): 16 requests, prompts 32..400 tokens, 32 new tokens
                each; kernel launch counts are zeroed just before and read
                just after; 4 streams and their first-step logits are
                compared with generate()
  6. train    — full gpt3-1.3b, bf16, B=4, S=1024, AdamW (lr 1e-4, wd
                0.01, fp32 moments), one batch repeated: a ScanTrainStep
                chunk of 3 warm-up steps, then one of 10 timed steps with
                the launch counts zeroed just before and read just after;
                tokens/s, step time, MFU, peak memory, losses (finite and
                falling) and exactly the launches a step that
                TRAIN_KERNELS_PER_STEP states
  7. train_recipe — the same cell with bench.py's recipe for this model
                (recompute, bf16 moments) and GPT-3's optimizer settings
                (a warm-up into a cosine schedule, global-norm clip,
                weight decay 0.1 on all but biases and LayerNorms): the
                same readings, the lr vector each step used (equal to the
                scheduler's values on the host), RECIPE_KERNELS_PER_STEP
                launches a step, and a peak memory below the train phase's
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from functools import partial

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12,    # dense tensor-core rate
            "float32": 67e12}      # fp32 outside the tensor cores
L2_COPIES = 4   # distinct input copies cycled where the caller finds its
#                 inputs cold: four sets of paged-attention slabs exceed
#                 the H100's 50 MB L2


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def time_cuda(fns, reps=21, per_rep=10, warmup=3):
    """(device_ms, call_ms) of one call, each the median of `reps` samples
    taken with CUDA events after `warmup` calls.

    `fns` holds equivalent calls on distinct copies of the inputs, cycled
    call by call, so that a call finds its inputs out of L2 where the real
    caller would (one entry: the inputs stay warm). device_ms: a spin
    kernel (`torch.cuda._sleep`) holds the stream while the host enqueues
    `per_rep` calls between two events, so a sample is back-to-back device
    work divided by `per_rep`; the spin lasts twice the measured enqueue
    time. call_ms: one call between two events with the host's launch cost
    included — what a call costs its caller."""
    import torch
    calls = [0]

    def call():
        fns[calls[0] % len(fns)]()
        calls[0] += 1

    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(per_rep):
        call()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    device, host = [], []
    for _ in range(reps):
        # 2e6 cycles per ms is at or above the H100's top SM clock
        torch.cuda._sleep(int(2 * enqueue_ms * 2.0e6))
        a.record()
        for _ in range(per_rep):
            call()
        b.record()
        b.synchronize()
        device.append(a.elapsed_time(b) / per_rep)
        a.record()
        call()
        b.record()
        b.synchronize()
        host.append(a.elapsed_time(b))
    return statistics.median(device), statistics.median(host)


def bound_ms(n_bytes, n_ops, dtype_name):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ulp_bf16(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    import torch
    a = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


# ---------------------------------------------------------------- phase 1
def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0].strip()
    emit({"phase": "device", "kind": name, "count": count,
          "nvidia_smi": smi_line,
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, count, smi_line


# ---------------------------------------------------------------- phase 2
# the kernels that must run on the tensor cores, each with the instructions
# that show it in its machine code: warpgroup products (wgmma's HGMMA) or
# warp products (mma.sync's HMMA)
TENSOR_CORE_KERNELS = {"flash_fwd_kernel_tc": ("HGMMA",),
                       "flash_bwd_dq_kernel_tc": ("HGMMA",),
                       "flash_bwd_dkv_kernel_tc": ("HGMMA",),
                       "paged_attention_kernel_tc": ("HMMA", "HGMMA")}


def tensor_core_instructions(sass, name, opcodes):
    """{symbol: counts} of the functions of `name` in a
    sass_instruction_counts() result; empty unless every one of them holds
    one of `opcodes`."""
    found = {k: c for k, c in sass.items() if name in k}
    if all(sum(c[op] for op in opcodes) > 0 for c in found.values()):
        return found
    return {}


def phase_build():
    from paddle_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    _kernels.load_library()
    seconds = time.perf_counter() - t0
    sass = _kernels.sass_instruction_counts()
    stats = _kernels.ptxas_kernel_stats(_kernels.ptxas_report)
    tensor_core, resources = {}, {}
    for name, opcodes in TENSOR_CORE_KERNELS.items():
        found = tensor_core_instructions(sass, name, opcodes)
        check(found, f"{name}: no {' or '.join(opcodes)} instruction in its "
                     f"machine code ({sass})")
        tensor_core[name] = list(found.values())
        if not _kernels.ptxas_report:
            continue     # loaded from an earlier build: no report to read
        mine = {k: v for k, v in stats.items() if name in k}
        check(mine, f"{name}: not in ptxas's report")
        spills = {k: v for k, v in mine.items()
                  if v["spill_stores"] or v["spill_loads"]}
        check(not spills, f"{name}: ptxas spills registers: {spills}")
        # every instantiation (the flash kernels': head dim 64/128 x plain,
        # mask, dropout) with its registers and HGMMA/HMMA count
        resources[name] = {k: dict(registers=v["registers"],
                                   spill_stores=v["spill_stores"],
                                   **found.get(k, {}))
                           for k, v in mine.items()}
    # ptxas's notes that it serialised a kernel's wgmmas (C7510-C7519):
    # reported, they cost the products their overlap
    serialized = sorted({line.split("function '")[1].split("'")[0]
                         for line in _kernels.ptxas_report.splitlines()
                         if "(C751" in line and "function '" in line})
    emit({"phase": "build", "seconds": seconds,
          "wgmma_serialized": serialized,
          "nvcc_seconds": _kernels.build_seconds,
          "sources": [f"paddle_tpu_torch/csrc/{s}" for s in _kernels.SOURCES],
          "tensor_core_instructions": tensor_core,
          "tensor_core_registers": resources or None,
          "layernorm": layernorm_build_checks(_kernels, stats),
          "ptxas": _kernels.ptxas_report or None})


# the LayerNorm kernels' 16-byte accesses, as cuobjdump names them
WIDE_OPCODES = ("LDG.E.128", "STG.E.128")


def layernorm_build_checks(_kernels, stats):
    """Every bf16 LayerNorm instantiation on the 16-byte path (the forward's
    and the backward's first pass, `kWide` true: `Lb1E` right after the
    type in the mangled name; one a table entry of ops/layernorm.py)
    holds LDG.E.128 and STG.E.128 in its machine code, and no LayerNorm
    kernel spills."""
    import torch
    from paddle_tpu_torch.ops import layernorm as ln
    sass = _kernels.sass_instruction_counts(WIDE_OPCODES)
    wide_re = re.compile(r"layernorm_(fwd|bwd)_kernelI13__nv_bfloat16Lb1E")
    wide = {k: c for k, c in sass.items() if wide_re.search(k)}
    want = (len(ln.FWD_BUCKETS[torch.bfloat16])
            + len(ln.BWD_BUCKETS[torch.bfloat16]))
    check(len(wide) == want and all(all(c[op] for op in WIDE_OPCODES)
                                    for c in wide.values()),
          f"bf16 LayerNorm kernels on the 16-byte path: {len(wide)} of "
          f"{want} found with {' and '.join(WIDE_OPCODES)}: {wide}; every "
          f"LayerNorm function's counts: "
          f"{ {k: c for k, c in sass.items() if 'layernorm' in k} }")
    mine = {k: v for k, v in stats.items() if "layernorm" in k}
    if _kernels.ptxas_report:
        check(mine, "no LayerNorm kernel in ptxas's report")
        spills = {k: v for k, v in mine.items()
                  if v["spill_stores"] or v["spill_loads"]}
        check(not spills, f"LayerNorm kernels spill registers: {spills}")
    return {"wide_bf16": {k: dict(c, registers=mine.get(k, {}).get(
                "registers")) for k, c in wide.items()},
            "registers": {k: v["registers"] for k, v in mine.items()},
            "spills": 0 if _kernels.ptxas_report else None}


# ---------------------------------------------------------------- phase 3
def _paged_case(torch, gen, *, dtype, H, Hkv, D, B=8, Tq=64, block_len=8,
                n_blocks=64, pad=64, lens=None, decode_rows=()):
    """Inputs shaped like the engine's unified step over its pool: slabs
    [B, Hkv, n_blocks*block_len + pad, D], a shuffled (non-identity) page
    table with -1 pads past each row's length, ragged lengths, prefill rows
    at q_pos = len - Tq and decode rows at q_pos = len - 1."""
    dev = "cuda"
    L = n_blocks * block_len + pad
    k = torch.randn(B, Hkv, L, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Hkv, L, D, generator=gen, device=dev).to(dtype)
    q = torch.randn(B, H, Tq, D, generator=gen, device=dev).to(dtype)
    cap = n_blocks * block_len
    if lens is None:
        lens = torch.randint(1, cap + 1, (B,), generator=gen,
                             device=dev).tolist()
    perm = torch.randperm(B * n_blocks, generator=gen, device=dev)
    table = perm.reshape(B, n_blocks).to(torch.int32)
    for b, n in enumerate(lens):
        table[b, -(-n // block_len):] = -1
    q_pos = [max(n - 1, 0) if b in decode_rows else max(n - Tq, 0)
             for b, n in enumerate(lens)]
    i32 = dict(dtype=torch.int32, device=dev)
    return dict(q=q, k=k, v=v, table=table,
                lens=torch.tensor(lens, **i32),
                q_pos=torch.tensor(q_pos, **i32),
                block_len=block_len, pages_per_row=n_blocks)


def _paged_bytes_ops(c):
    """Bytes the function must move and the operations it must do.

    Bytes: q read and out written once; K and V of each row's first
    seq_len columns once per kv head; the table entries of the occupied
    blocks, the lengths and the positions. Operations: QK and PV, two per
    multiply-add, over the columns each query row sees,
    min(seq_len, q_pos + t + 1)."""
    q, k = c["q"], c["k"]
    B, H, Tq, D = q.shape
    Hkv = k.shape[1]
    el = q.element_size()
    bl = c["block_len"]
    lens = c["lens"].tolist()
    kv_bytes = sum(lens) * Hkv * D * 2 * el
    side = (sum(-(-n // bl) for n in lens) + 2 * B) * 4
    n_bytes = 2 * q.numel() * el + kv_bytes + side
    seen = sum(min(n, p + t + 1) for n, p in zip(lens, c["q_pos"].tolist())
               for t in range(Tq))
    n_ops = 4 * H * D * seen
    return n_bytes, n_ops


def _sdpa_inputs(torch, c):
    """The library yardstick's inputs: each row's pages gathered into a
    contiguous [B, H, S, D] cache (GQA heads repeated) and the ragged causal
    mask as a boolean [B, 1, Tq, S]. Built once, outside the timing."""
    from paddle_tpu_torch.ops.paged_attention import _gather_block
    q, k, v, table = c["q"], c["k"], c["v"], c["table"]
    B, H, Tq, D = q.shape
    n_rep = H // k.shape[1]
    bl, ppr = c["block_len"], c["pages_per_row"]
    idx = table.long().clamp_min(0)
    ks = torch.cat([_gather_block(k, idx[:, j], bl, ppr)
                    for j in range(table.shape[1])], dim=2)
    vs = torch.cat([_gather_block(v, idx[:, j], bl, ppr)
                    for j in range(table.shape[1])], dim=2)
    ks = ks.repeat_interleave(n_rep, dim=1).contiguous()
    vs = vs.repeat_interleave(n_rep, dim=1).contiguous()
    S = ks.shape[2]
    col = torch.arange(S, device=q.device)
    row = c["q_pos"].long()[:, None] + torch.arange(Tq, device=q.device)
    mask = ((col[None, None, :] <= row[:, :, None])
            & (col[None, None, :] < c["lens"].long()[:, None, None]))
    return q, ks, vs, mask[:, None]


# bf16 paged attention, kernel against plain version. Both round one fp32
# output to bf16 after sums taken in another order, so nearly every element
# agrees within one bf16 ulp of the output. Both also round p to bf16
# before PV: where the two sides' fp32 p of one column straddle a rounding
# boundary, that p moves by one ulp of p (at most 2^-8) and the output by
# that times |v| / l, which rows with few visible columns feel most; such
# columns are rare. The readings on the H100 (PERF.md) put one element in
# a million past one ulp, by 4e-9. The limits: every element within
# BF16_PA_ULPS ulps + BF16_PA_ATOL, room for a p flip in a short row, and
# at most BF16_PA_SHARE of the elements more than one ulp apart. A side
# that skipped the p rounding would move nearly every output by a
# fraction of an ulp of p, and fail the share.
BF16_PA_ULPS = 2
BF16_PA_ATOL = 1e-3
BF16_PA_SHARE = 1e-3


def check_paged(torch, c, label, tol=None):
    """Kernel against plain version on the case `c`. bf16 takes the limits
    above; fp32 takes atol = rtol = `tol`. Returns (readings, args)."""
    from paddle_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                      paged_attention_plain)
    scale = 1.0 / math.sqrt(c["q"].shape[-1])
    args = (c["q"], c["k"], c["v"], c["table"], c["lens"], c["q_pos"],
            c["block_len"], c["pages_per_row"], scale)
    out = paged_attention_cuda(*args)
    ref = paged_attention_plain(*args)
    torch.cuda.synchronize()
    check(torch.isfinite(out.float()).all().item(),
          f"paged attention {label}: non-finite output")
    err = (out.float() - ref.float()).abs()
    worst = float(err.max())
    if c["q"].dtype == torch.bfloat16:
        ulp = ulp_bf16(torch.maximum(out.float().abs(), ref.float().abs()))
        readings = dict(
            max_abs_err=worst,
            max_excess_over_1ulp=float((err - ulp).max()),
            max_excess_over_2ulp=float((err - 2 * ulp).max()),
            share_over_1ulp=float((err > ulp).float().mean()))
        check(readings["max_excess_over_2ulp"] <= BF16_PA_ATOL,
              f"paged attention {label}: an element is "
              f"{readings['max_excess_over_2ulp']} past {BF16_PA_ULPS} bf16 "
              f"ulps, limit {BF16_PA_ATOL}")
        check(readings["share_over_1ulp"] <= BF16_PA_SHARE,
              f"paged attention {label}: {readings['share_over_1ulp']} of "
              f"the elements are more than one bf16 ulp apart, limit "
              f"{BF16_PA_SHARE}")
    else:
        readings = dict(max_abs_err=worst)
        check(bool((err <= tol + tol * ref.float().abs()).all()),
              f"paged attention {label}: max |kernel - plain| = {worst} "
              f"exceeds atol = rtol = {tol}")
    return readings, args


def check_layernorm(torch, x, w, b, label, bf16_ulp=False, atol=1e-5):
    from paddle_tpu_torch.ops.layernorm import (layer_norm_fwd_cuda,
                                                layer_norm_fwd_plain)
    y, mu, rstd = layer_norm_fwd_cuda(x, w, b, 1e-5)
    y_ref, mu_ref, rstd_ref = layer_norm_fwd_plain(x, w, b, 1e-5)
    torch.cuda.synchronize()
    check(torch.isfinite(y.float()).all().item(),
          f"layernorm {label}: non-finite output")
    err = (y.float() - y_ref.float()).abs()
    worst = float(err.max())
    if bf16_ulp:
        # both round an fp32 value to bf16 once; the fp32 values differ by
        # sum order in mean/variance, so near a rounding midpoint they land
        # one bf16 ulp apart, and near y = 0 (x_hat*w cancelling b) the
        # fp32 difference itself, ~1e-6, survives: 1 ulp + 1e-5
        big = torch.maximum(y.float().abs(), y_ref.float().abs())
        ok = bool((err <= ulp_bf16(big) + 1e-5).all())
        what = "one bf16 ulp of the output + 1e-5"
    else:
        ok = bool((err <= atol + atol * y_ref.float().abs()).all())
        what = f"atol/rtol {atol}"
    check(ok, f"layernorm {label}: max |kernel - plain| = {worst} exceeds "
              f"{what}")
    stat_err = max(float((mu - mu_ref).abs().max()),
                   float(((rstd - rstd_ref) / rstd_ref).abs().max()))
    check(stat_err <= 1e-5, f"layernorm {label}: mean/rstd differ by "
                            f"{stat_err}")
    return worst


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                      paged_attention_plain,
                                                      paged_route)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    results = {}

    # ---- paged attention at the served path's shapes: gpt3-1.3b heads
    # (H=16, D=128), 8 slots, 64-wide rows, block_len 8, lengths up to 512
    lens = [512, 37, 200, 1, 448, 64, 300, 129]
    decode_rows = (1, 3, 6)
    cases = {}
    bf = _paged_case(torch, gen, dtype=torch.bfloat16, H=16, Hkv=16, D=128,
                     lens=lens, decode_rows=decode_rows)
    cases["bf16"], args_bf = check_paged(torch, bf, "bf16 H16 D128")
    # fp32: same op sequence, sums in another order: 1e-5
    f32 = _paged_case(torch, gen, dtype=torch.float32, H=16, Hkv=16, D=128,
                      lens=lens, decode_rows=decode_rows)
    cases["fp32"] = check_paged(torch, f32, "fp32 H16 D128", 1e-5)[0]
    # GQA (4 query heads per kv head), bf16 and fp32
    gqa = _paged_case(torch, gen, dtype=torch.bfloat16, H=16, Hkv=4, D=128,
                      lens=lens, decode_rows=decode_rows)
    cases["gqa_bf16"] = check_paged(torch, gqa, "GQA bf16")[0]
    gqa32 = _paged_case(torch, gen, dtype=torch.float32, H=8, Hkv=2, D=64,
                        B=3, Tq=5, block_len=32, n_blocks=6, pad=8)
    cases["gqa_fp32_d64_bl32"] = check_paged(torch, gqa32,
                                             "GQA fp32 D64 bl32", 1e-5)[0]
    odd = _paged_case(torch, gen, dtype=torch.float32, H=2, Hkv=2, D=128,
                      B=2, Tq=1, block_len=16, n_blocks=3, pad=0,
                      lens=[48, 17], decode_rows=(0, 1))
    cases["decode_fp32_bl16"] = check_paged(torch, odd, "decode fp32 bl16",
                                            1e-5)[0]
    # bf16 at the other block lengths: every tensor-core instantiation the
    # tests reach (block_len 16, 24, 64; D 64; Tq past one 64-row tile;
    # decode rows) and block_len 12, which the route sends to the scalar
    # kernel; lengths of the served kind
    for label, kw in {
            "bf16_gqa_d64_bl16": dict(H=8, Hkv=2, D=64, B=3, Tq=90,
                                      block_len=16, n_blocks=12, pad=8,
                                      lens=[192, 100, 150],
                                      decode_rows=(1,)),
            "bf16_bl24": dict(H=4, Hkv=4, D=128, B=3, Tq=33, block_len=24,
                              n_blocks=9, pad=0, lens=[216, 80, 130],
                              decode_rows=(1,)),
            "bf16_gqa_bl64_decode": dict(H=8, Hkv=1, D=128, B=2, Tq=1,
                                         block_len=64, n_blocks=5, pad=0,
                                         lens=[320, 77], decode_rows=(0, 1)),
            "bf16_bl12_scalar": dict(H=4, Hkv=2, D=128, B=3, Tq=20,
                                     block_len=12, n_blocks=10, pad=4,
                                     lens=[120, 45, 90])
            }.items():
        c = _paged_case(torch, gen, dtype=torch.bfloat16, **kw)
        cases[label] = check_paged(torch, c, label)[0]
        cases[label]["route"] = paged_route(torch.bfloat16, kw["block_len"],
                                            kw["D"])
    # a row's sums run in one fixed order: two runs are bit-equal
    for label, c in (("bf16 H16 D128", bf), ("GQA bf16", gqa)):
        a = (c["q"], c["k"], c["v"], c["table"], c["lens"], c["q_pos"],
             c["block_len"], c["pages_per_row"], 1.0 / math.sqrt(128))
        runs = [paged_attention_cuda(*a) for _ in range(2)]
        torch.cuda.synchronize()
        check(torch.equal(*runs), f"paged attention {label}: two runs differ")
    emit({"phase": "kernel_checks", "name": "paged_attention_bitwise",
          "runs": 2, "equal": ["bf16 H16 D128", "GQA bf16"]})

    # each layer of a served step reads its own slabs, which the layers
    # before it have pushed out of L2: every timing cycles input copies
    q, ks, vs, mask = _sdpa_inputs(torch, bf)
    scale = 1.0 / math.sqrt(128)
    slabs = [args_bf[1:3]] + [(args_bf[1].clone(), args_bf[2].clone())
                              for _ in range(L2_COPIES - 1)]
    pa_ms, pa_call_ms = time_cuda([
        partial(paged_attention_cuda, args_bf[0], k, v, *args_bf[3:])
        for k, v in slabs])
    # the plain version is ~1000 small launches a call: one call a sample
    pa_plain_ms, _ = time_cuda([
        partial(paged_attention_plain, args_bf[0], k, v, *args_bf[3:])
        for k, v in slabs], per_rep=1, warmup=1)
    lib_kv = [(ks, vs)] + [(ks.clone(), vs.clone())
                           for _ in range(L2_COPIES - 1)]
    pa_lib_ms, _ = time_cuda([
        partial(F.scaled_dot_product_attention, q, k, v, attn_mask=mask,
                scale=scale) for k, v in lib_kv])
    del slabs, lib_kv
    n_bytes, n_ops = _paged_bytes_ops(bf)
    pa_bound, pa_by = bound_ms(n_bytes, n_ops, "bfloat16")
    results["paged_attention"] = dict(
        route=paged_route(torch.bfloat16, 8, 128),
        max_abs_err=cases["bf16"]["max_abs_err"],
        tol=f"bf16: each element within {BF16_PA_ULPS} bf16 ulps + "
            f"{BF16_PA_ATOL}, at most {BF16_PA_SHARE} of them past one ulp; "
            f"fp32 atol=rtol=1e-5",
        ms=pa_ms, call_ms=pa_call_ms, plain_ms=pa_plain_ms,
        library_ms=pa_lib_ms,
        bound_ms=pa_bound, bound_by=pa_by, bytes=n_bytes, ops=n_ops,
        tflops=n_ops / pa_ms / 1e9, share_of_bound=pa_bound / pa_ms,
        shape=dict(B=8, H=16, Hkv=16, Tq=64, D=128, block_len=8,
                   pages_per_row=64, seq_lens=lens, dtype="bfloat16"),
        cases=cases)
    emit({"phase": "kernel", "name": "paged_attention",
          **results["paged_attention"]})

    # ---- LayerNorm at the served path's shapes: R = 8 slots x 64, N = 2048
    R, N = 8 * 64, 2048
    ln_cases = {}
    x32 = torch.randn(R, N, generator=gen, device="cuda") * 3 + 0.5
    w32 = torch.randn(N, generator=gen, device="cuda")
    b32 = torch.randn(N, generator=gen, device="cuda")
    ln_cases["fp32"] = check_layernorm(torch, x32, w32, b32, "fp32 512x2048")
    xb, wb, bb = (t.to(torch.bfloat16) for t in (x32, w32, b32))
    ln_cases["bf16"] = check_layernorm(torch, xb, wb, bb, "bf16 512x2048",
                                       bf16_ulp=True)
    for (r, n) in ((3, 8192), (5, 1000), (1, 1)):
        xe = torch.randn(r, n, generator=gen, device="cuda")
        we = torch.randn(n, generator=gen, device="cuda")
        be = torch.randn(n, generator=gen, device="cuda")
        ln_cases[f"fp32_{r}x{n}"] = check_layernorm(torch, xe, we, be,
                                                    f"fp32 {r}x{n}")
    emit({"phase": "kernel_checks", "name": "layernorm_rows",
          **check_layernorm_rows(torch, gen)})
    results["layernorm_fwd"] = layernorm_fwd_reading(torch, xb, wb, bb,
                                                     ln_cases)
    emit({"phase": "kernel", "name": "layernorm_fwd",
          **results["layernorm_fwd"]})
    return results


def check_layernorm_rows(torch, gen, R=512, head=64):
    """A row's forward does not depend on the rows around it: the first
    `head` rows of an R-row call equal a `head`-row call on those rows, and
    each equals a one-row call, bit for bit (y, mean and rstd), as the
    engine's steps and generate() need. The same rows at an odd storage
    offset (scalar accesses) equal them too. bf16 at N = 2048 (the
    served width) and fp32 at N = 1000 (a width of whole packs whose
    rows are still 16-byte aligned)."""
    from paddle_tpu_torch.ops.layernorm import layer_norm_fwd_cuda
    done = {}
    for dtype, N in ((torch.bfloat16, 2048), (torch.float32, 1000)):
        x, w, b = (torch.randn(*s, generator=gen, device="cuda").to(dtype)
                   for s in ((R, N), (N,), (N,)))
        full = layer_norm_fwd_cuda(x, w, b, 1e-5)
        part = layer_norm_fwd_cuda(x[:head], w, b, 1e-5)
        buf = torch.empty(head * N + 1, device="cuda", dtype=dtype)
        odd = buf[1:].view(head, N)
        odd.copy_(x[:head])
        scalar = layer_norm_fwd_cuda(odd, w, b, 1e-5)
        label = f"{str(dtype).split('.')[-1]} {R}x{N}"
        for name, f, p, q in zip(("y", "mean", "rstd"), full, part, scalar):
            check(torch.equal(f[:head], p),
                  f"layernorm {label}: rows 0..{head} of the {R}-row call "
                  f"differ from a {head}-row call ({name})")
            check(torch.equal(p, q),
                  f"layernorm {label}: the scalar-access path differs from "
                  f"the 16-byte one ({name})")
        for i in range(head):
            one = layer_norm_fwd_cuda(x[i:i + 1], w, b, 1e-5)
            for name, p, o in zip(("y", "mean", "rstd"), part, one):
                check(torch.equal(p[i:i + 1], o),
                      f"layernorm {label}: row {i} alone differs from the "
                      f"{head}-row call ({name})")
        done[label] = {"rows": head, "equal": ["y", "mean", "rstd"]}
    return {"bitwise": done}


def layernorm_fwd_reading(torch, xb, wb, bb, cases, cold=False):
    """The LayerNorm forward's line at the bf16 shape of `xb`: its error
    (from `cases`, the checks already made), its time, the plain version's
    and F.layer_norm's, and its bound. A step's LayerNorm reads the
    residual sum the op before it just wrote, so its input stays warm in L2
    here too (`ms`). With `cold`, a second reading cycles the input over
    L2_COPIES copies, kernel and F.layer_norm alike (`cold_ms`,
    `cold_library_ms`): a warm L2 can read under the HBM bound."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.layernorm import (layer_norm_fwd_cuda,
                                                layer_norm_fwd_plain)
    R, N = xb.shape
    ms, call_ms = time_cuda([partial(layer_norm_fwd_cuda, xb, wb, bb, 1e-5)])
    plain_ms, _ = time_cuda([partial(layer_norm_fwd_plain, xb, wb, bb,
                                     1e-5)])
    lib_ms, _ = time_cuda([partial(F.layer_norm, xb, (N,), wb, bb, 1e-5)])
    el = xb.element_size()
    n_bytes = 2 * R * N * el + 2 * N * el + 2 * R * 4
    n_ops = 8 * R * N
    bound, by = bound_ms(n_bytes, n_ops, "bfloat16")
    line = dict(
        max_abs_err=cases["bf16"],
        tol="one bf16 ulp of the output + 1e-5 (bf16); fp32 atol=rtol=1e-5; "
            "mean and rstd within 1e-5",
        ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=bound, bound_by=by, bytes=n_bytes, ops=n_ops,
        share_of_bound=bound / ms,
        shape=dict(R=R, N=N, dtype="bfloat16"), cases=cases)
    if cold:
        xs = [xb] + [xb.clone() for _ in range(L2_COPIES - 1)]
        line["cold_ms"], _ = time_cuda([
            partial(layer_norm_fwd_cuda, x_, wb, bb, 1e-5) for x_ in xs])
        line["cold_library_ms"], _ = time_cuda([
            partial(F.layer_norm, x_, (N,), wb, bb, 1e-5) for x_ in xs])
        line["cold_share_of_bound"] = bound / line["cold_ms"]
        del xs
    return line


# ------------------------------------------------ phase 3b: training kernels
# bf16 training kernels against their plain versions. The yardstick is the
# plain version run in fp32 on the same bf16 inputs: the kernel's largest
# error from it may be at most BF16_TRAIN_FACTOR times the bf16 plain
# version's own, plus BF16_TRAIN_ATOL. Both bf16 sides round the same
# values (p, ds and the outputs) to bf16 once, after fp32 sums taken in
# another order, so their errors are of one size: a rounding that lands on
# the other side of a midpoint moves an element by at most half an ulp
# more than the plain version's worst, well inside the factor of 2. The
# atol (a quarter of a bf16 ulp at 0.25) covers outputs whose plain error
# happens to be near 0. A wrong mask, tile or formula moves elements by
# their own size and fails; fp32 cases hold the algorithm to 1e-5 (forward
# and dx, one op sequence) or 1e-4 (sums of up to 4096 products, dq, dk,
# dv, dw, db, taken in another order).
BF16_TRAIN_FACTOR = 2.0
BF16_TRAIN_ATOL = 2.0 ** -12
TRAIN_B, TRAIN_S = 4, 1024          # bench.py's gpt3-1.3b batch


def bf16_vs_fp32_plain(torch, got, plain_bf16, plain_fp32):
    """(kernel error, plain bf16 error, limit) against the fp32 plain
    version, as maxima of absolute differences."""
    ref = plain_fp32.float()
    err_k = float((got.float() - ref).abs().max())
    err_p = float((plain_bf16.float() - ref).abs().max())
    return err_k, err_p, BF16_TRAIN_FACTOR * err_p + BF16_TRAIN_ATOL


def _check_close(torch, got, ref, tol, what):
    err = (got.float() - ref.float()).abs()
    worst = float(err.max()) if err.numel() else 0.0
    check(bool((err <= tol + tol * ref.float().abs()).all()),
          f"{what}: max |kernel - plain| = {worst} exceeds atol = rtol = "
          f"{tol}")
    return worst


def _check_bf16(torch, got, plain_bf16, plain_fp32, what):
    err_k, err_p, limit = bf16_vs_fp32_plain(torch, got, plain_bf16,
                                             plain_fp32)
    check(err_k <= limit, f"{what}: kernel is {err_k} from the fp32 plain "
                          f"version, limit {limit} ({BF16_TRAIN_FACTOR} x "
                          f"the bf16 plain version's {err_p} + "
                          f"{BF16_TRAIN_ATOL})")
    return dict(err=err_k, plain_err=err_p)


def _flash_inputs(torch, gen, B, H, Sq, Sk, D, dtype):
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    return r(B, H, Sq, D), r(B, H, Sk, D), r(B, H, Sk, D), r(B, H, Sq, D)


def check_flash(torch, q, k, v, g, causal, label):
    """Forward, dq and dk/dv kernels against the plain versions on one
    case. Returns the readings."""
    from paddle_tpu_torch.ops.attention import (flash_attention_delta,
                                                flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda,
                                                flash_bwd_plain,
                                                flash_fwd_cuda,
                                                flash_fwd_plain)
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = flash_fwd_cuda(q, k, v, causal, scale)
    delta = flash_attention_delta(g, out)
    dq = flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal, scale)
    torch.cuda.synchronize()
    for t, n in ((out, "out"), (lse, "lse"), (dq, "dq"), (dk, "dk"),
                 (dv, "dv")):
        check(bool(torch.isfinite(t.float()).all()),
              f"flash {label}: non-finite {n}")
    ref_out, ref_lse = flash_fwd_plain(q, k, v, causal, scale)
    ref_b = flash_bwd_plain(q, k, v, g, lse, delta, causal, scale)
    readings = {}
    if q.dtype == torch.float32:
        readings["out"] = _check_close(torch, out, ref_out, 1e-5,
                                       f"flash {label} out")
        readings["lse"] = _check_close(torch, lse, ref_lse, 1e-5,
                                       f"flash {label} lse")
        for n, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), ref_b):
            readings[n] = _check_close(torch, got, ref, 1e-4,
                                       f"flash {label} {n}")
        return readings
    f32 = [t.float() for t in (q, k, v, g)]
    ref32_out, ref32_lse = flash_fwd_plain(*f32[:3], causal, scale)
    ref32_b = flash_bwd_plain(*f32, lse, delta, causal, scale)
    readings["out"] = _check_bf16(torch, out, ref_out, ref32_out,
                                  f"flash {label} out")
    # lse is fp32 on both sides, from the same bf16 inputs
    readings["lse"] = _check_close(torch, lse, ref_lse, 1e-5,
                                   f"flash {label} lse")
    for n, got, ref, ref32 in zip(("dq", "dk", "dv"), (dq, dk, dv), ref_b,
                                  ref32_b):
        readings[n] = _check_bf16(torch, got, ref, ref32,
                                  f"flash {label} {n}")
    return readings


def visible_pairs(Sq, Sk, causal):
    """The (query, key) pairs of one batch*head a causal (bottom-right
    aligned) or full mask leaves visible."""
    if causal:
        return sum(max(0, min(Sk, r + (Sk - Sq) + 1)) for r in range(Sq))
    return Sq * Sk


def flash_bytes_ops(B, H, Sq, Sk, D, causal, el):
    """(bytes, operations) of the forward, dq and dk/dv functions.

    Pairs: the (query, key) pairs a causal (bottom-right aligned) or full
    mask leaves visible. Forward reads q, k, v and writes out and the fp32
    lse, doing QK and PV (4·D operations a pair); dq reads q, k, v, g, lse
    and delta and writes dq, doing QK, g·v and ds·k (6·D); dk/dv reads the
    same and writes dk and dv, doing QK, g·v, p·g and ds·q (8·D)."""
    pairs = visible_pairs(Sq, Sk, causal) * B * H
    qb, kb = B * H * Sq * D * el, B * H * Sk * D * el
    row = B * H * Sq * 4
    return {"flash_fwd": (2 * qb + 2 * kb + row, 4 * D * pairs),
            "flash_bwd_dq": (3 * qb + 2 * kb + 2 * row, 6 * D * pairs),
            "flash_bwd_dkv": (2 * qb + 4 * kb + 2 * row, 8 * D * pairs)}


def check_layernorm_bwd(torch, x, w, b, dy, label):
    from paddle_tpu_torch.ops.layernorm import (layer_norm_bwd_cuda,
                                                layer_norm_bwd_plain,
                                                layer_norm_fwd_cuda)
    _, mu, rstd = layer_norm_fwd_cuda(x, w, b, 1e-5)
    got = layer_norm_bwd_cuda(x, w, mu, rstd, dy)
    torch.cuda.synchronize()
    ref = layer_norm_bwd_plain(x, w, mu, rstd, dy)
    names = ("dx", "dw", "db")
    for t, n in zip(got, names):
        check(bool(torch.isfinite(t.float()).all()),
              f"layernorm_bwd {label}: non-finite {n}")
    if x.dtype == torch.float32:
        return {n: _check_close(torch, a, r, 1e-5 if n == "dx" else 1e-4,
                                f"layernorm_bwd {label} {n}")
                for n, a, r in zip(names, got, ref)}
    ref32 = layer_norm_bwd_plain(x.float(), w.float(), mu, rstd, dy.float())
    return {n: _check_bf16(torch, a, r, r32, f"layernorm_bwd {label} {n}")
            for n, a, r, r32 in zip(names, got, ref, ref32)}


def _sdpa_bwd_call(torch, F, q, k, v, g):
    """One backward of F.scaled_dot_product_attention(is_causal=True) on a
    graph built once (the library's dq, dk and dv together)."""
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    return partial(torch.autograd.grad, out, (qr, kr, vr), g,
                   retain_graph=True)


def _ln_bwd_call(torch, F, x, w, b, dy):
    """One backward of F.layer_norm on a graph built once."""
    xr, wr, br = (t.detach().requires_grad_() for t in (x, w, b))
    y = F.layer_norm(xr, (x.shape[-1],), wr, br, 1e-5)
    return partial(torch.autograd.grad, y, (xr, wr, br), dy,
                   retain_graph=True)


def phase_train_kernels():
    """The training slice's kernels against their plain versions at the
    training shapes (gpt3-1.3b: B=4, H=16, S=1024, D=128, bf16, causal;
    LayerNorm R = 4096, N = 2048) and at edge shapes, then timed."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.attention import (flash_attention_delta,
                                                flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda,
                                                flash_bwd_plain,
                                                flash_fwd_cuda,
                                                flash_fwd_plain)
    from paddle_tpu_torch.ops.layernorm import (layer_norm_bwd_cuda,
                                                layer_norm_bwd_plain,
                                                layer_norm_fwd_cuda)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    B, H, S, D = TRAIN_B, 16, TRAIN_S, 128
    bf = torch.bfloat16
    cases = {}
    q, k, v, g = _flash_inputs(torch, gen, B, H, S, S, D, bf)
    cases["bf16_train_causal"] = check_flash(torch, q, k, v, g, True,
                                             "bf16 [4,16,1024,128] causal")
    for name, (b_, h_, sq, sk, d_, dt, causal) in {
            "fp32_causal": (2, 4, 256, 256, 128, torch.float32, True),
            "fp32_noncausal": (2, 4, 256, 256, 128, torch.float32, False),
            "fp32_sq_lt_sk": (1, 3, 100, 300, 64, torch.float32, True),
            "fp32_sq_gt_sk": (1, 3, 300, 100, 64, torch.float32, True),
            "fp32_ragged_d64": (2, 2, 200, 200, 64, torch.float32, True),
            "fp32_ragged_d32_noncausal": (1, 2, 77, 130, 32,
                                          torch.float32, False),
            "bf16_ragged_d64": (2, 4, 333, 333, 64, bf, True),
            "bf16_sq_gt_sk_noncausal": (1, 4, 190, 70, 128, bf, False),
            "bf16_sq_lt_sk_d32": (1, 3, 100, 300, 32, bf, True),
            "bf16_one_row_d16": (1, 2, 1, 1, 16, bf, True),
            "bf16_bh160": (4, 40, 128, 128, 128, bf, True)}.items():
        cases[name] = check_flash(
            torch, *_flash_inputs(torch, gen, b_, h_, sq, sk, d_, dt),
            causal, name)
    emit({"phase": "kernel_checks", "name": "flash_attention",
          "cases": cases})
    # fixed summation order, no atomics: two runs are bit-equal
    scale = 1.0 / math.sqrt(D)
    runs = []
    for _ in range(2):
        out, lse = flash_fwd_cuda(q, k, v, True, scale)
        delta = flash_attention_delta(g, out)
        runs.append((out, lse,
                     flash_bwd_dq_cuda(q, k, v, g, lse, delta, True, scale),
                     *flash_bwd_dkv_cuda(q, k, v, g, lse, delta, True,
                                         scale)))
    torch.cuda.synchronize()
    names = ("out", "lse", "dq", "dk", "dv")
    for n, a, b in zip(names, *runs):
        check(torch.equal(a, b), f"flash bf16 {n}: two runs differ")
    emit({"phase": "kernel_checks", "name": "flash_attention_bitwise",
          "runs": 2, "equal": list(names)})
    del runs

    # LayerNorm backward: the training rows (4 x 1024) at width 2048
    R, N = TRAIN_B * TRAIN_S, 2048
    x32 = torch.randn(R, N, generator=gen, device="cuda") * 3 + 0.5
    w32 = torch.randn(N, generator=gen, device="cuda")
    b32 = torch.randn(N, generator=gen, device="cuda")
    dy32 = torch.randn(R, N, generator=gen, device="cuda")
    ln_cases = {"fp32": check_layernorm_bwd(torch, x32, w32, b32, dy32,
                                            "fp32 4096x2048")}
    xb, wb, bb, dyb = (t.to(bf) for t in (x32, w32, b32, dy32))
    ln_cases["bf16"] = check_layernorm_bwd(torch, xb, wb, bb, dyb,
                                           "bf16 4096x2048")
    # the forward at the training rows: y, mean and rstd against the plain
    # version, so the statistics the backward takes are held too
    fwd_cases = {"fp32": check_layernorm(torch, x32, w32, b32,
                                         "fp32 4096x2048"),
                 "bf16": check_layernorm(torch, xb, wb, bb, "bf16 4096x2048",
                                         bf16_ulp=True)}
    for (r, n) in ((3, 8192), (5, 1000), (1, 1), (70001, 64)):
        t = [torch.randn(*s, generator=gen, device="cuda")
             for s in ((r, n), (n,), (n,), (r, n))]
        ln_cases[f"fp32_{r}x{n}"] = check_layernorm_bwd(torch, *t,
                                                        f"fp32 {r}x{n}")
        fwd_cases[f"fp32_{r}x{n}"] = check_layernorm(torch, *t[:3],
                                                     f"fp32 {r}x{n}")
    emit({"phase": "kernel_checks", "name": "layernorm_bwd",
          "cases": ln_cases})

    # ---- timing at the training shapes. Attention's inputs (67 MB) and
    # the LayerNorm backward's x and dy (34 MB) are cycled over two copies,
    # so a call finds them out of L2, as a layer of a train step does.
    results = {}
    copies = [(q, k, v, g)] + [tuple(t.clone() for t in (q, k, v, g))]
    outs = []
    for cq, ck, cv, cg in copies:
        o, lse = flash_fwd_cuda(cq, ck, cv, True, scale)
        outs.append((o, lse, flash_attention_delta(cg, o)))
    t = {}
    t["flash_fwd"] = time_cuda([partial(flash_fwd_cuda, cq, ck, cv, True,
                                        scale) for cq, ck, cv, _ in copies])
    t["flash_bwd_dq"] = time_cuda([
        partial(flash_bwd_dq_cuda, cq, ck, cv, cg, lse, dl, True, scale)
        for (cq, ck, cv, cg), (_, lse, dl) in zip(copies, outs)])
    t["flash_bwd_dkv"] = time_cuda([
        partial(flash_bwd_dkv_cuda, cq, ck, cv, cg, lse, dl, True, scale)
        for (cq, ck, cv, cg), (_, lse, dl) in zip(copies, outs)])
    plain_fwd, _ = time_cuda([partial(flash_fwd_plain, q, k, v, True,
                                      scale)], per_rep=2)
    o, lse, dl = outs[0]
    plain_bwd, _ = time_cuda([partial(flash_bwd_plain, q, k, v, g, lse, dl,
                                      True, scale)], per_rep=2)
    lib_fwd, _ = time_cuda([partial(F.scaled_dot_product_attention, cq, ck,
                                    cv, is_causal=True)
                            for cq, ck, cv, _ in copies])
    lib_bwd, _ = time_cuda([_sdpa_bwd_call(torch, F, *c) for c in copies])
    del outs, copies
    plain = {"flash_fwd": plain_fwd, "flash_bwd_dq": plain_bwd,
             "flash_bwd_dkv": plain_bwd}
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd,
               "flash_bwd_dkv": lib_bwd}
    bo = flash_bytes_ops(B, H, S, S, D, True, 2)
    tol = (f"bf16: max error from the fp32 plain version <= "
           f"{BF16_TRAIN_FACTOR} x the bf16 plain version's + "
           f"{BF16_TRAIN_ATOL}; fp32 atol=rtol=1e-5 (out, lse), 1e-4 "
           f"(dq, dk, dv)")
    read = cases["bf16_train_causal"]
    err = {"flash_fwd": read["out"]["err"], "flash_bwd_dq": read["dq"]["err"],
           "flash_bwd_dkv": max(read["dk"]["err"], read["dv"]["err"])}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        n_bytes, n_ops = bo[name]
        bound, by = bound_ms(n_bytes, n_ops, "bfloat16")
        results[name] = dict(
            max_abs_err=err[name], tol=tol, ms=t[name][0],
            call_ms=t[name][1], plain_ms=plain[name],
            library_ms=library[name], bound_ms=bound, bound_by=by,
            bytes=n_bytes, ops=n_ops,
            tflops=n_ops / t[name][0] / 1e9,
            share_of_bound=bound / t[name][0],
            shape=dict(B=B, H=H, Sq=S, Sk=S, D=D, causal=True,
                       dtype="bfloat16"),
            note=(None if name == "flash_fwd" else
                  "plain_ms and library_ms compute dq, dk and dv together"))
        emit({"phase": "kernel", "name": name, **results[name]})

    _, mu, rstd = layer_norm_fwd_cuda(xb, wb, bb, 1e-5)
    ln_in = [(xb, dyb), (xb.clone(), dyb.clone())]
    ln_ms, ln_call_ms = time_cuda([partial(layer_norm_bwd_cuda, x_, wb, mu,
                                           rstd, dy_) for x_, dy_ in ln_in])
    ln_plain, _ = time_cuda([partial(layer_norm_bwd_plain, xb, wb, mu, rstd,
                                     dyb)])
    ln_lib, _ = time_cuda([_ln_bwd_call(torch, F, x_, wb, bb, dy_)
                           for x_, dy_ in ln_in])
    el = xb.element_size()
    ln_bytes = 3 * R * N * el + N * el + 2 * R * 4 + 2 * N * el
    ln_ops = 13 * R * N     # the plain formula's operations an element
    ln_bound, ln_by = bound_ms(ln_bytes, ln_ops, "bfloat16")
    results["layernorm_bwd"] = dict(
        max_abs_err=max(v["err"] for v in ln_cases["bf16"].values()),
        tol=(f"bf16: max error from the fp32 plain version <= "
             f"{BF16_TRAIN_FACTOR} x the bf16 plain version's + "
             f"{BF16_TRAIN_ATOL}; fp32 atol=rtol=1e-5 (dx), 1e-4 (dw, db)"),
        ms=ln_ms, call_ms=ln_call_ms, plain_ms=ln_plain, library_ms=ln_lib,
        bound_ms=ln_bound, bound_by=ln_by, bytes=ln_bytes, ops=ln_ops,
        share_of_bound=ln_bound / ln_ms,
        shape=dict(R=R, N=N, dtype="bfloat16"),
        note="library_ms: the backward of F.layer_norm (dx, dw, db)")
    emit({"phase": "kernel", "name": "layernorm_bwd",
          **results["layernorm_bwd"]})
    results["layernorm_fwd_train"] = layernorm_fwd_reading(
        torch, xb, wb, bb, fwd_cases, cold=True)
    emit({"phase": "kernel", "name": "layernorm_fwd",
          **results["layernorm_fwd_train"]})
    torch.cuda.empty_cache()
    return results


# ------------------------------------------------ phase 3c: the optimizer
# Fused Adam against its plain version on the card: bit for bit (tolerance
# 0). Both run _adam_math's operations in one order, each rounded once (the
# kernel uses the explicitly rounded intrinsics, so nothing becomes an FMA;
# PyTorch's elementwise kernels round every operation alike), and bf16
# outputs are one round-to-nearest-even of the same fp32 value. The leaves:
# a ragged n, n < 1024, linear1.weight and the largest, the word embedding
# (lm_head.weight is as large).
ADAM_LEAVES = {"n2049": 2049, "n1000": 1000,
               "linear1.weight": 2048 * 8192,
               "word_embeddings.weight": 50304 * 2048}
ADAM_OPS = 16     # fp32 operations an element (_adam_math, either decay)
ADAM_HP = dict(beta1=0.9, beta2=0.95, epsilon=1e-8)


def _adam_leaf(torch, gen, n, pdtype, mdtype, master):
    """p, g, m1, m2 and the optional fp32 master of one flat leaf."""
    def r():
        return torch.randn(n, generator=gen, device="cuda")
    p32 = r()
    return dict(p=p32.to(pdtype), g=r().to(pdtype), m1=(r() * 0.1).to(mdtype),
                m2=(r().abs() * 0.01).to(mdtype),
                master=p32 if master else None)


def adam_scalars(torch, lr=1e-4, step=5):
    """lr, beta1^t and beta2^t as 0-d fp32 tensors on the card."""
    f32 = dict(dtype=torch.float32, device="cuda")
    return (torch.tensor(lr, **f32),
            torch.tensor(ADAM_HP["beta1"] ** step, **f32),
            torch.tensor(ADAM_HP["beta2"] ** step, **f32))


def adam_bytes_ops(n, p_el, m_el, master):
    """Bytes fused Adam must move over a leaf of n elements (p, m1, m2 and
    the master read and written, g read) and its operations."""
    per = 2 * p_el + p_el + 4 * m_el + (8 if master else 0)
    return n * per, n * ADAM_OPS


def check_adam(torch, c, decoupled, label):
    """Kernel against plain version on one leaf, bit for bit. Returns the
    largest |difference| (0 when it passes)."""
    from paddle_tpu_torch.ops.fused_adam import (fused_adam_cuda,
                                                 fused_adam_plain)
    ref = {k: None if v is None else v.clone() for k, v in c.items()}
    kw = dict(ADAM_HP, decoupled=decoupled)
    fused_adam_cuda(c["p"], c["g"], c["m1"], c["m2"], *adam_scalars(torch),
                    0.1, master=c["master"], **kw)
    fused_adam_plain(ref["p"], ref["g"], ref["m1"], ref["m2"],
                     *adam_scalars(torch), 0.1, master=ref["master"], **kw)
    torch.cuda.synchronize()
    worst = 0.0
    for k in ("p", "m1", "m2", "master"):
        if c[k] is None:
            continue
        check(bool(torch.isfinite(c[k].float()).all()),
              f"fused_adam {label}: non-finite {k}")
        d = float((c[k].float() - ref[k].float()).abs().max())
        worst = max(worst, d)
        check(torch.equal(c[k], ref[k]),
              f"fused_adam {label}: {k} is not bit-equal to the plain "
              f"version (max |kernel - plain| = {d})")
    return worst


def phase_adam_kernel():
    """Fused Adam against its plain version over ADAM_LEAVES in every dtype
    the path takes (p and g bf16 or fp32; moments fp32 or bf16; a master
    weight), decoupled or not; then timed at the largest leaf with the
    train cell's dtypes (bf16 p and g, fp32 moments) and the recipe's (bf16
    moments), beside its plain version and torch._fused_adamw_."""
    import torch
    from paddle_tpu_torch.ops.fused_adam import (fused_adam_cuda,
                                                 fused_adam_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    f32, bf = torch.float32, torch.bfloat16
    dtypes = {"fp32": (f32, f32, False), "fp32_p_bf16_m": (f32, bf, False),
              "bf16_p_fp32_m": (bf, f32, False), "bf16": (bf, bf, False),
              "bf16_master_fp32_m": (bf, f32, True),
              "bf16_master_bf16_m": (bf, bf, True)}
    cases = {}
    for leaf, n in ADAM_LEAVES.items():
        for dname, (pd, md, master) in dtypes.items():
            for decoupled in (False, True):
                label = f"{leaf} {dname} decoupled={decoupled}"
                c = _adam_leaf(torch, gen, n, pd, md, master)
                cases[label] = check_adam(torch, c, decoupled, label)
                del c
    torch.cuda.empty_cache()
    emit({"phase": "kernel_checks", "name": "fused_adam", "cases": cases})

    n = ADAM_LEAVES["word_embeddings.weight"]
    readings = {}
    for cfg, md in (("train", f32), ("recipe", bf)):
        c = _adam_leaf(torch, gen, n, bf, md, False)
        sc = adam_scalars(torch)
        args = (c["p"], c["g"], c["m1"], c["m2"], *sc, 0.1)
        kw = dict(ADAM_HP, decoupled=True)
        # a leaf of 1.4-2.3 GB is far past the 50 MB L2: every call cold
        ms, call_ms = time_cuda([partial(fused_adam_cuda, *args, **kw)])
        plain_ms, _ = time_cuda([partial(fused_adam_plain, *args, **kw)],
                                per_rep=2)
        n_bytes, n_ops = adam_bytes_ops(n, 2, md.itemsize, False)
        bound, by = bound_ms(n_bytes, n_ops, "float32")
        readings[cfg] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, bytes=n_bytes,
                             ops=n_ops, shape=dict(n=n, p="bfloat16",
                                                   g="bfloat16",
                                                   moments=str(md)[6:]))
        del c, args
    # the library yardstick: torch._fused_adamw_ (torch.optim.AdamW's
    # fused=True path) on the same leaf, all four tensors bf16: it takes
    # one dtype for p, g and the moments
    lib = [torch.randn(n, generator=gen, device="cuda").to(bf)
           for _ in range(4)]
    lib[3].abs_()
    steps = [torch.tensor(5.0, device="cuda")]
    lib_ms, _ = time_cuda([partial(
        torch._fused_adamw_, [lib[0]], [lib[1]], [lib[2]], [lib[3]], [],
        steps, lr=1e-4, beta1=ADAM_HP["beta1"], beta2=ADAM_HP["beta2"],
        weight_decay=0.1, eps=ADAM_HP["epsilon"], amsgrad=False,
        maximize=False)])
    del lib
    torch.cuda.empty_cache()
    # the main path's reading is the recipe's (bf16 moments); the train
    # phase's fp32 moments beside it
    result = dict(
        max_abs_err=max(cases.values()),
        tol="0: bit for bit against the plain version on the card, every "
            "dtype, master and decay case",
        **readings["recipe"], library_ms=lib_ms,
        at_train_dtypes=readings["train"],
        note="library_ms: torch._fused_adamw_ on the same leaf with bf16 p, "
             "g and moments (14 bytes an element, as the recipe's dtypes)")
    emit({"phase": "kernel", "name": "fused_adam", **result})
    return {"fused_adam": result}


# ---------------------------------- phase 3d: the mask and dropout variants
# The additive-mask and dropout variants of the flash forward, dq and dk/dv
# at gpt3-1.3b's attention width ([4, 16, 1024, 128] bf16), each against
# its plain version under the training kernels' rule (fp32 cases at
# [2, 4, 256, 64] under the fp32 flash limits), the device keep-mask
# against its plain twin bit for bit, then driven through the entry points
# (scaled_dot_product_attention, [B, S, H, D]) with the launch counts
# zeroed just before and read just after, and timed.
VARIANT_LENGTHS = (1024, 777, 512, 129)   # case a's valid keys a row
VARIANT_P = 0.1
VARIANT_SEED = 0x5EED0F1A5                # above 2**32: both key words
VARIANT_CASES = {  # mask, causal, dropout p; "plain": the reference's rule
    "a": ("padding", False, 0.0), "b": ("padding", True, 0.0),
    "c": ("normal_bf16_per_head", False, 0.0), "d": ("normal_3d", False, 0.0),
    "e": (None, True, VARIANT_P), "f": ("padding", True, VARIANT_P)}
# case f's dmask: the plain reference run in bf16 rounds p, dp and out to
# bf16 once each on the way; four bf16 ulps at the largest |dmask| (2^-6
# of it) bound what that rounding can move an element
VARIANT_DMASK_PLAIN_REL = 2.0 ** -6


def padding_mask(torch, lengths, S, device="cuda"):
    """Key padding as an additive mask [B, 1, S, S] fp32: 0 on the first
    lengths[b] keys, -inf past them."""
    cols = torch.arange(S, device=device)
    lens = torch.tensor(lengths, device=device)
    m = torch.where(cols[None, :] < lens[:, None], 0.0, float("-inf"))
    return m[:, None, None, :].expand(len(lengths), 1, S, S).contiguous()


def _variant_mask(torch, gen, kind, B, H, S):
    if kind == "padding":
        return padding_mask(torch, VARIANT_LENGTHS[:B], S)
    if kind == "normal_bf16_per_head":
        return torch.randn(B, H, S, S, generator=gen,
                           device="cuda").bfloat16()
    if kind == "normal_3d":
        return torch.randn(B, S, S, generator=gen, device="cuda")
    return None


def variant_bytes_ops(B, H, S, D, causal, el, mask_rows):
    """flash_bytes_ops of the plain kernels plus the fp32 mask each
    variant reads once: of each of its rows ([rows, Sq, Sk]), the entries
    of the visible pairs only (a causal function needs none above the
    diagonal); dropout adds no bytes, and its Philox (integer work on the
    CUDA cores) is not counted in the operations, which stay the products
    on the tensor cores."""
    bo = flash_bytes_ops(B, H, S, S, D, causal, el)
    extra = mask_rows * visible_pairs(S, S, causal) * 4
    return {k: (b + extra, o) for k, (b, o) in bo.items()}


def check_variant(torch, q, k, v, g, causal, mask, p, seed, label):
    """The variant kernels against their plain versions on one case, as
    check_flash does. Returns (readings, (out, lse, dq, dk, dv))."""
    from paddle_tpu_torch.ops.attention import (dropout_keep_mask,
                                                flash_attention_delta,
                                                flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda,
                                                flash_bwd_plain,
                                                flash_fwd_cuda,
                                                flash_fwd_plain)
    B, H, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    keep = dropout_keep_mask(seed, B, H, S, S, p, "cuda") if p else None
    out, lse = flash_fwd_cuda(q, k, v, causal, scale, mask, p, seed)
    delta = flash_attention_delta(g, out)
    dq = flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal, scale, mask, p,
                           seed)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal, scale, mask,
                                p, seed)
    torch.cuda.synchronize()
    got = (out, lse, dq, dk, dv)
    for t, n in zip(got, ("out", "lse", "dq", "dk", "dv")):
        check(bool(torch.isfinite(t.float()).all()),
              f"flash variant {label}: non-finite {n}")
    ref_out, ref_lse = flash_fwd_plain(q, k, v, causal, scale, mask, keep, p)
    ref_b = flash_bwd_plain(q, k, v, g, lse, delta, causal, scale, mask,
                            keep, p)
    readings = {"lse": _check_close(torch, lse, ref_lse, 1e-5,
                                    f"flash variant {label} lse")}
    if q.dtype == torch.float32:
        readings["out"] = _check_close(torch, out, ref_out, 1e-5,
                                       f"flash variant {label} out")
        for n, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref_b):
            readings[n] = _check_close(torch, a, r, 1e-4,
                                       f"flash variant {label} {n}")
        return readings, got
    f32 = [t.float() for t in (q, k, v, g)]
    ref32_out, _ = flash_fwd_plain(*f32[:3], causal, scale, mask, keep, p)
    ref32_b = flash_bwd_plain(*f32, lse, delta, causal, scale, mask, keep, p)
    readings["out"] = _check_bf16(torch, out, ref_out, ref32_out,
                                  f"flash variant {label} out")
    for n, a, r, r32 in zip(("dq", "dk", "dv"), (dq, dk, dv), ref_b,
                            ref32_b):
        readings[n] = _check_bf16(torch, a, r, r32,
                                  f"flash variant {label} {n}")
    return readings, got


def _sdpa_masked_bwd_call(torch, F, q, k, v, g, **kw):
    """One backward of F.scaled_dot_product_attention(**kw) on a graph
    built once (dq, dk and dv together)."""
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qr, kr, vr, **kw)
    return partial(torch.autograd.grad, out, (qr, kr, vr), g,
                   retain_graph=True)


def _sdpa_fwd_bwd_call(torch, sdpa, copy, causal, mask):
    """One forward + backward of the port's scaled_dot_product_attention
    on `copy` (q, k, v, g [B, H, S, D], passed as [B, S, H, D] views)."""
    q, k, v, g = (t.transpose(1, 2) for t in copy)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def run():
        o = sdpa(*leaves, attn_mask=mask, is_causal=causal, training=True)
        torch.autograd.grad(o, leaves, g)
    return run


def phase_attention_variants():
    """Phase 3d. Returns ({kernel name: reading}, launch counts of the
    entry-point run)."""
    import torch
    import torch.nn.functional as F
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.core.random import next_seed
    from paddle_tpu_torch.ops import _kernels, scaled_dot_product_attention
    from paddle_tpu_torch.ops.attention import (_attention_reference,
                                                _mask_grad,
                                                dropout_keep_mask,
                                                dropout_keep_mask_cuda,
                                                flash_attention_delta,
                                                flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda,
                                                flash_bwd_plain,
                                                flash_fwd_cuda,
                                                flash_fwd_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    B, H, S, D = TRAIN_B, 16, TRAIN_S, 128
    bf = torch.bfloat16
    scale = 1.0 / math.sqrt(D)

    # ---- the keep-mask: device (philox.cuh) against the plain twin
    keep_dev = dropout_keep_mask_cuda(VARIANT_SEED, B, H, S, S, VARIANT_P)
    keep = dropout_keep_mask(VARIANT_SEED, B, H, S, S, VARIANT_P, "cuda")
    check(torch.equal(keep_dev, keep),
          "the device keep-mask differs from dropout_keep_mask")
    n = keep.numel()
    rate = float(keep.float().mean())
    sigma = math.sqrt(VARIANT_P * (1 - VARIANT_P) / n)
    check(abs(rate - (1 - VARIANT_P)) < 5 * sigma,
          f"keep rate {rate} is not within 5 sigma ({sigma}) of "
          f"{1 - VARIANT_P}")
    other = dropout_keep_mask_cuda(VARIANT_SEED + 1, B, H, S, S, VARIANT_P)
    check(not torch.equal(other, keep_dev), "a second seed gave the same "
                                            "keep-mask")
    keep_reading = dict(elements=n, keep_rate=rate, sigma=sigma,
                        bit_equal=True, second_seed_differs=True)
    del keep_dev, keep, other

    # ---- every variant kernel against its plain version
    q, k, v, g = _flash_inputs(torch, gen, B, H, S, S, D, bf)
    masks = {c: _variant_mask(torch, gen, kind, B, H, S)
             for c, (kind, _, _) in VARIANT_CASES.items() if c != "f"}
    masks["f"] = masks["a"]
    cases, outs = {}, {}
    for c in "abcde":
        _, causal, p = VARIANT_CASES[c]
        cases[c], outs[c] = check_variant(
            torch, q, k, v, g, causal, masks[c], p, VARIANT_SEED,
            f"{c} bf16 [4,16,1024,128]")
    gen32 = torch.Generator(device="cuda")
    gen32.manual_seed(SEED + 7)
    t32 = _flash_inputs(torch, gen32, 2, 4, 256, 256, 64, torch.float32)
    pad32 = padding_mask(torch, (256, 129), 256)
    for c in "abe":
        _, causal, p = VARIANT_CASES[c]
        cases[f"fp32_{c}"], _ = check_variant(
            torch, *t32, causal, None if p else pad32, p, VARIANT_SEED,
            f"{c} fp32 [2,4,256,64]")
    del t32, pad32
    # bf16 variants run twice are bit-equal; another seed moves dropout
    for c in "abcde":
        _, causal, p = VARIANT_CASES[c]
        _, again = check_variant(torch, q, k, v, g, causal, masks[c], p,
                                 VARIANT_SEED, f"{c} again")
        for n_, a, b_ in zip(("out", "lse", "dq", "dk", "dv"), outs[c],
                             again):
            check(torch.equal(a, b_), f"flash variant {c} {n_}: two runs "
                                      f"differ")
    moved = flash_fwd_cuda(q, k, v, True, scale, None, VARIANT_P,
                           VARIANT_SEED + 1)[0]
    check(not torch.equal(moved, outs["e"][0]),
          "dropout with another seed gave the same output")
    # dmask through the kernels (case a, mask.requires_grad): _mask_grad
    # on the kernels' lse against the plain versions'
    out_a, lse_a = outs["a"][:2]
    dm = _mask_grad(q, k, v, masks["a"], lse_a, g,
                    flash_attention_delta(g, out_a), False, scale)
    ro, rl = flash_fwd_plain(q, k, v, False, scale, masks["a"])
    dm_plain = _mask_grad(q, k, v, masks["a"], rl, g,
                          flash_attention_delta(g, ro), False, scale)
    f32 = [t.float() for t in (q, k, v, g)]
    ro32, rl32 = flash_fwd_plain(*f32[:3], False, scale, masks["a"])
    dm32 = _mask_grad(*f32[:3], masks["a"], rl32, f32[3],
                      flash_attention_delta(f32[3], ro32), False, scale)
    cases["a"]["dmask"] = _check_bf16(torch, dm, dm_plain, dm32,
                                      "flash variant a dmask")
    del dm, dm_plain, dm32, ro, rl, ro32, rl32
    emit({"phase": "kernel_checks", "name": "flash_attention_variants",
          "keep_mask": keep_reading, "cases": cases,
          "bitwise_runs": 2, "cases_by_letter": {
              c: dict(mask=m, causal=cz, dropout_p=p)
              for c, (m, cz, p) in VARIANT_CASES.items()}})

    # ---- the entry points, counts zeroed just before and read just after
    bshd = [t.transpose(1, 2) for t in (q, k, v)]     # [B, S, H, D] views
    g_bshd = g.transpose(1, 2)
    ptt.seed(SEED)
    seed_e = next_seed()
    ptt.seed(SEED)
    entry = {}
    _kernels.reset_launch_counts()
    for c in "abcdef":
        _, causal, p = VARIANT_CASES[c]
        leaves = [t.detach().requires_grad_() for t in bshd]
        m = masks[c]
        if c == "f":
            m = m.detach().clone().requires_grad_()
        before = _kernels.launch_counts()
        o = scaled_dot_product_attention(*leaves, attn_mask=m, dropout_p=p,
                                         is_causal=causal, training=True)
        o.backward(g_bshd)
        torch.cuda.synchronize()
        after = _kernels.launch_counts()
        entry[c] = dict(out=o.detach(), grads=[t.grad for t in leaves],
                        dmask=m.grad if c == "f" else None,
                        launched={n_: after[n_] - before[n_]
                                  for n_ in after if after[n_] > before[n_]})
    launches = _kernels.launch_counts()
    for c in "abcd":
        check(entry[c]["launched"] == dict.fromkeys(
            ("flash_fwd_mask", "flash_bwd_dq_mask", "flash_bwd_dkv_mask"), 1),
            f"case {c} launched {entry[c]['launched']}")
    check(entry["e"]["launched"] == dict.fromkeys(
        ("flash_fwd_dropout", "flash_bwd_dq_dropout",
         "flash_bwd_dkv_dropout"), 1),
        f"case e launched {entry['e']['launched']}")
    check(entry["f"]["launched"] == {},
          f"case f (mask and dropout: the plain reference) launched "
          f"{entry['f']['launched']}")
    # a-d through the entry point are the kernels' outputs, bit for bit
    for c in "abcd":
        o, dq_, dk_, dv_ = (entry[c]["out"], *entry[c]["grads"])
        ref = outs[c]
        check(torch.equal(o.transpose(1, 2), ref[0])
              and torch.equal(dq_.transpose(1, 2), ref[2])
              and torch.equal(dk_.transpose(1, 2), ref[3])
              and torch.equal(dv_.transpose(1, 2), ref[4]),
              f"case {c}: the entry point differs from its kernels")
    # e drew its seed from core.random: the kernels at that seed
    want_e = check_variant(torch, q, k, v, g, True, None, VARIANT_P, seed_e,
                           "e at the entry point's seed")[1]
    check(torch.equal(entry["e"]["out"].transpose(1, 2), want_e[0])
          and torch.equal(entry["e"]["grads"][0].transpose(1, 2), want_e[2]),
          "case e: the entry point differs from its kernels at its seed")
    del want_e
    # f: the plain reference with the Philox keep-mask of its seed
    ptt.seed(SEED)
    next_seed()                      # case e's
    seed_f = next_seed()
    keep_f = dropout_keep_mask(seed_f, B, H, S, S, VARIANT_P, "cuda")
    mf = masks["f"].detach().clone().requires_grad_()
    lf = [t.detach().requires_grad_() for t in (q, k, v)]
    of = _attention_reference(*lf, True, scale, mf, VARIANT_P, keep_f)
    of.backward(g)
    check(torch.equal(entry["f"]["out"].transpose(1, 2), of.detach())
          and torch.equal(entry["f"]["dmask"], mf.grad),
          "case f: the entry point is not the plain reference with its "
          "keep-mask")
    m32 = masks["f"].detach().clone().requires_grad_()
    l32 = [t.detach().float().requires_grad_() for t in (q, k, v)]
    o32 = _attention_reference(*l32, True, scale, m32, VARIANT_P, keep_f)
    o32.backward(g.float())
    dm_err = float((mf.grad.float() - m32.grad).abs().max())
    dm_lim = VARIANT_DMASK_PLAIN_REL * float(m32.grad.abs().max())
    check(dm_err <= dm_lim, f"case f dmask is {dm_err} from the fp32 plain "
                            f"reference, limit {dm_lim}")
    cases["f"] = dict(route="plain", dmask_err=dm_err, dmask_limit=dm_lim,
                      out_err=float((of.float() - o32).abs().max().detach()))
    del of, o32, mf, m32, lf, l32, keep_f, entry
    emit({"phase": "attention_variants", "entry": "scaled_dot_product_"
          "attention([B,S,H,D], attn_mask, dropout_p, is_causal, training)",
          "launches": {n_: c for n_, c in launches.items() if c},
          "case_f": cases["f"]})

    # ---- timing at [4,16,1024,128] bf16: cases a (mask), b (mask, causal)
    # and e (dropout, causal), each beside the kernel without the variant
    # and one library call; inputs cycled over two copies (67 MB each)
    copies = [(q, k, v, g), tuple(t.clone() for t in (q, k, v, g))]
    results = {}
    for c in "abe":
        _, causal, p = VARIANT_CASES[c]
        mask = masks[c]
        fwd_outs = [flash_fwd_cuda(cq, ck, cv, causal, scale, mask, p,
                                   VARIANT_SEED) for cq, ck, cv, _ in copies]
        deltas = [flash_attention_delta(cg, o) for (_, _, _, cg), (o, _)
                  in zip(copies, fwd_outs)]
        t = {"flash_fwd": time_cuda([
            partial(flash_fwd_cuda, cq, ck, cv, causal, scale, mask, p,
                    VARIANT_SEED) for cq, ck, cv, _ in copies])}
        t["flash_bwd_dq"] = time_cuda([
            partial(flash_bwd_dq_cuda, cq, ck, cv, cg, lse, dl, causal, scale,
                    mask, p, VARIANT_SEED)
            for (cq, ck, cv, cg), (_, lse), dl in zip(copies, fwd_outs,
                                                      deltas)])
        t["flash_bwd_dkv"] = time_cuda([
            partial(flash_bwd_dkv_cuda, cq, ck, cv, cg, lse, dl, causal,
                    scale, mask, p, VARIANT_SEED)
            for (cq, ck, cv, cg), (_, lse), dl in zip(copies, fwd_outs,
                                                      deltas)])
        # the same kernels without the variant
        base = {"flash_fwd": time_cuda([
            partial(flash_fwd_cuda, cq, ck, cv, causal, scale)
            for cq, ck, cv, _ in copies])[0]}
        base["flash_bwd_dq"] = time_cuda([
            partial(flash_bwd_dq_cuda, cq, ck, cv, cg, lse, dl, causal,
                    scale) for (cq, ck, cv, cg), (_, lse), dl
            in zip(copies, fwd_outs, deltas)])[0]
        base["flash_bwd_dkv"] = time_cuda([
            partial(flash_bwd_dkv_cuda, cq, ck, cv, cg, lse, dl, causal,
                    scale) for (cq, ck, cv, cg), (_, lse), dl
            in zip(copies, fwd_outs, deltas)])[0]
        keep_c = (dropout_keep_mask(VARIANT_SEED, B, H, S, S, p, "cuda")
                  if p else None)
        lse0, dl0 = fwd_outs[0][1], deltas[0]
        plain_fwd, _ = time_cuda([partial(flash_fwd_plain, q, k, v, causal,
                                          scale, mask, keep_c, p)],
                                 per_rep=2)
        plain_bwd, _ = time_cuda([partial(flash_bwd_plain, q, k, v, g, lse0,
                                          dl0, causal, scale, mask, keep_c,
                                          p)], per_rep=2)
        if p:
            kw = dict(dropout_p=p, is_causal=True)
        else:
            lib_mask = mask if not causal else torch.where(
                torch.ones(S, S, dtype=torch.bool, device="cuda").tril(),
                mask, float("-inf"))
            kw = dict(attn_mask=lib_mask.to(q.dtype))
        lib_fwd, _ = time_cuda([partial(F.scaled_dot_product_attention, cq,
                                        ck, cv, **kw)
                                for cq, ck, cv, _ in copies])
        lib_bwd, _ = time_cuda([_sdpa_masked_bwd_call(torch, F, *cp, **kw)
                                for cp in copies])
        rows = 0 if p else mask.shape[0]
        bo = variant_bytes_ops(B, H, S, D, causal, 2, rows)
        suffix = "_dropout" if p else "_mask"
        plain = {"flash_fwd": plain_fwd, "flash_bwd_dq": plain_bwd,
                 "flash_bwd_dkv": plain_bwd}
        read = cases[c]
        err = {"flash_fwd": read["out"]["err"],
               "flash_bwd_dq": read["dq"]["err"],
               "flash_bwd_dkv": max(read["dk"]["err"], read["dv"]["err"])}
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            n_bytes, n_ops = bo[name]
            bound, by = bound_ms(n_bytes, n_ops, "bfloat16")
            reading = dict(
                case=c, max_abs_err=err[name],
                tol=(f"bf16: max error from the fp32 plain version <= "
                     f"{BF16_TRAIN_FACTOR} x the bf16 plain version's + "
                     f"{BF16_TRAIN_ATOL}; fp32 cases atol=rtol=1e-5 (out, "
                     f"lse), 1e-4 (dq, dk, dv); keep-mask bit for bit"),
                ms=t[name][0], call_ms=t[name][1], plain_ms=plain[name],
                library_ms=lib_fwd if name == "flash_fwd" else lib_bwd,
                without_variant_ms=base[name], bound_ms=bound, bound_by=by,
                bytes=n_bytes, ops=n_ops, tflops=n_ops / t[name][0] / 1e9,
                share_of_bound=bound / t[name][0],
                shape=dict(B=B, H=H, Sq=S, Sk=S, D=D, causal=causal,
                           dtype="bfloat16",
                           mask=None if p else list(mask.shape),
                           dropout_p=p),
                note=(None if name == "flash_fwd" else
                      "plain_ms and library_ms compute dq, dk and dv "
                      "together; library_ms: F.scaled_dot_product_"
                      "attention's backward with " + ", ".join(kw)))
            emit({"phase": "kernel", "name": name + suffix, **reading})
            if c == "b":
                results[name + suffix]["causal_case_b"] = reading
            else:
                results[name + suffix] = reading
        del fwd_outs, deltas, keep_c
    # the entry point converts a mask to the kernels' fp32 rows once a
    # forward (FlashAttentionFn): forward + backward with the README's
    # key padding [B, 1, 1, Sk] and case c's bf16 per-head mask, each
    # beside the same mask handed over already in that layout
    for name, c, given in (("key_padding_b11s", "a",
                            masks["a"][:, :, :1].contiguous()),
                           ("per_head_bf16", "c", masks["c"])):
        _, causal, _ = VARIANT_CASES[c]
        laid = masks[c].float().contiguous()
        ms = {}
        for how, m in (("given", given), ("laid_out", laid)):
            ms[how] = time_cuda([_sdpa_fwd_bwd_call(
                torch, scaled_dot_product_attention, cp, causal, m)
                for cp in copies])[0]
        results["flash_fwd_mask"][f"entry_{name}"] = dict(
            case=c, mask=list(given.shape), mask_dtype=str(given.dtype)[6:],
            fwd_bwd_ms=ms["given"], laid_out_fwd_bwd_ms=ms["laid_out"],
            conversion_ms=ms["given"] - ms["laid_out"],
            note="scaled_dot_product_attention forward + backward "
                 "([B,S,H,D]); laid_out: the same mask as fp32 [rows, Sq, "
                 "Sk], which the kernels take without a copy")
        del laid
    del copies, masks, outs
    torch.cuda.empty_cache()
    return results, launches


# ---------------------------------------------------------------- phase 4
def _record_steps(engine, prompts, max_new):
    """Drive a SimClock engine to completion, recording every unified
    step's inputs (toks, pos, adv) and its logits (on the CPU)."""
    handles = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    steps = []
    orig = engine._step_logits

    def recording(toks, pos, adv):
        lg = orig(toks, pos, adv)
        steps.append(((toks.copy(), pos.copy(), adv.copy()),
                      lg.float().cpu()))
        return lg

    engine._step_logits = recording
    try:
        while engine.has_work():
            engine.pump()
    finally:
        engine._step_logits = orig
    for h in handles:
        h.result(0)
    return steps


def phase_model():
    """gpt3-1.3b widths cut to 2 layers (a depth cut), fp32: the engine's
    unified steps on the card, with the CUDA kernels, replayed step by step
    on a CPU twin with the same weights and the plain versions. Each step
    feeds both sides the same rows, so a near-tie that flips one greedy
    token cannot make later steps diverge."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cpu")
    gen.manual_seed(SEED)
    cpu = GPTForCausalLM.from_preset("gpt3-1.3b", device="cpu",
                                     dtype="float32", generator=gen,
                                     num_hidden_layers=2)
    card = GPTForCausalLM.from_preset("gpt3-1.3b", device="cuda",
                                      dtype="float32", num_hidden_layers=2)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(SEED)
    # 8 slots: two prompts longer than one 64-wide chunk, the rest shorter,
    # so the steps mix prefill chunks with decode rows
    plens = (100, 5, 130, 30, 12, 64, 7, 45)
    prompts = [rng.randint(0, 50304, (n,)).astype(np.int32) for n in plens]
    cfg = LLMEngineConfig(num_slots=8, block_len=8, n_blocks=64,
                          prefill_chunk=64)
    launches0 = _kernels.launch_counts()
    steps = _record_steps(LLMEngine(card, cfg, clock=SimClock()), prompts, 4)
    launched = {k: v - launches0[k] for k, v in
                _kernels.launch_counts().items()}
    check(all(launched[k] > 0 for k in SERVE_KERNELS),
          f"card engine did not launch every served kernel: {launched}")
    twin = LLMEngine(cpu, cfg, clock=SimClock())
    # fp32 on both sides (TF32 off): GEMMs with K up to 8192 summed in
    # another order on the card and the CPU move logits of magnitude ~1 by
    # ~1e-5; 1e-3 leaves room and still catches any real kernel fault
    tol = 1e-3
    worst = 0.0
    real_cols = equal_cols = 0
    for (toks, pos, adv), lg_card in steps:
        lg_cpu = twin._step_logits(toks, pos, adv).float()
        check(bool(torch.isfinite(lg_card).all()),
              "non-finite logits on the card")
        worst = max(worst, float((lg_card - lg_cpu).abs().max()))
        for r in range(len(adv)):
            n = int(adv[r])
            a = lg_card[r, :n].argmax(-1)
            b = lg_cpu[r, :n].argmax(-1)
            real_cols += n
            equal_cols += int((a == b).sum())
    emit({"phase": "model", "config": "gpt3-1.3b widths, 2 layers, fp32",
          "steps": len(steps), "logits_max_abs_diff": worst, "tol": tol,
          "greedy_tokens_equal": equal_cols, "greedy_tokens": real_cols,
          "kernel_launches": launched})
    check(worst <= tol, f"card vs CPU logits differ by {worst} > {tol}")
    del cpu, card, twin, steps
    torch.cuda.empty_cache()


def _train_steps(model, device, chunk, steps, recipe=False):
    """`steps` steps of `model` through ScanTrainStep over `chunk`: AdamW
    (lr TRAIN_PARITY_LR, wd 0.01, global-norm clip 1.0) or, with `recipe`,
    the train recipe's optimizer peaking at TRAIN_PARITY_LR. Returns (the
    [K] losses on the CPU, the lr vector the steps used)."""
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ScanTrainStep
    if recipe:
        opt = recipe_optimizer(model.parameters(), TRAIN_PARITY_LR)
    else:
        opt = AdamW(learning_rate=TRAIN_PARITY_LR, weight_decay=0.01,
                    parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
    step = ScanTrainStep(model, opt, scan_steps=steps, device=device)
    return step(*chunk).cpu(), step.lr_vector


# train parity, card against a CPU twin, fp32 (TF32 off). Losses: GEMMs
# with K up to 8192 and the chunked CE over 50304 columns summed in
# another order move a loss of ~11 by ~1e-5; 1e-4 leaves room. Weights:
# Adam normalises each gradient, so where a gradient is near 0 the two
# sides' rounding can flip its sign and move that element's update by up
# to 2 x lr a step: the largest difference may reach 6 x lr over 3 steps,
# but such elements are rare; at most TRAIN_PARITY_SHARE of the elements
# may differ by more than lr / 10. Adam's update barely depends on a
# gradient's size, so the weights cannot see a gradient scaled by a
# constant: the first step's gradient norm of every leaf, before the clip,
# is held to rtol TRAIN_PARITY_GRAD_RTOL as well. fp32 sums taken in
# another order move a norm by ~1e-7 of itself (PERF.md); a kernel that
# returned 2*dk or dq/2 would move its leaves' norms by far more than
# 1e-4.
TRAIN_PARITY_LR = 1e-4
TRAIN_PARITY_LOSS_TOL = 1e-4
TRAIN_PARITY_SHARE = 1e-3
TRAIN_PARITY_GRAD_RTOL = 1e-4


def _grad_norms(model, device, ids, labels):
    """{parameter name: fp32 norm of its gradient} of one forward and
    backward of `model` on (ids, labels), before any clip; the gradients
    are dropped again and the weights are left as they were."""
    import torch
    from paddle_tpu_torch.parallel import make_compute_loss
    loss = make_compute_loss(model)(torch.from_numpy(ids).to(device),
                                    torch.from_numpy(labels).to(device))
    loss.backward()
    norms = {}
    for name, p in model.named_parameters():
        if p.requires_grad:
            # in fp64: an fp32 norm over a 12.6 M-element leaf on the CPU
            # is itself off by ~5e-4 of the result
            norms[name] = float(p.grad.double().norm())
            p.grad = None
    return norms


def launches_per_step(n_layers, leaves, recompute):
    """Kernel launches one train step of a GPT with `n_layers` layers and
    `leaves` parameters must make: a flash forward and two LayerNorm
    forwards a layer, twice with recompute (the backward reruns the
    layer), plus the final LayerNorm; one dq, one dk/dv and two LayerNorm
    backwards a layer plus the final one; one fused Adam a leaf."""
    f = 2 if recompute else 1
    return {"flash_fwd": n_layers * f, "flash_bwd_dq": n_layers,
            "flash_bwd_dkv": n_layers, "layernorm_fwd": 2 * n_layers * f + 1,
            "layernorm_bwd": 2 * n_layers + 1, "fused_adam": leaves}


def phase_model_train():
    """gpt3-1.3b widths cut to 2 layers (a depth cut), fp32, B=2, S=128:
    3 steps through ScanTrainStep on the card (kernels) and on a CPU twin
    with the same weights (plain versions), once with AdamW and once with
    the train recipe (its optimizer at TRAIN_PARITY_LR's scale, and
    recompute): the first step's gradient norm of every leaf, per-step
    losses and the final parameters."""
    import numpy as np
    import torch
    from paddle_tpu_torch.bridge import export_state
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.parallel import stack_batches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(SEED + 3)
    B, S, K = 2, 128, 3
    ids = rng.randint(0, 50304, (B, S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100                    # ignored tokens on the path
    chunk = stack_batches([(ids, labels)] * K)
    for recipe in (False, True):
        gen = torch.Generator(device="cpu")
        gen.manual_seed(SEED + 3)
        over = dict(num_hidden_layers=2, use_recompute=recipe)
        cpu = GPTForCausalLM.from_preset("gpt3-1.3b", device="cpu",
                                         dtype="float32", generator=gen,
                                         **over)
        card = GPTForCausalLM.from_preset("gpt3-1.3b", device="cuda",
                                          dtype="float32", **over)
        card.load_state_dict(cpu.state_dict())
        cpu.train()
        card.train()
        g_card = _grad_norms(card, "cuda", ids, labels)
        g_cpu = _grad_norms(cpu, "cpu", ids, labels)
        grad_rel = {k: abs(g_card[k] - g_cpu[k]) / g_cpu[k] for k in g_cpu}
        worst_grad = max(grad_rel, key=grad_rel.get)
        _kernels.reset_launch_counts()
        loss_card, lr_card = _train_steps(card, "cuda", chunk, K, recipe)
        launched = _kernels.launch_counts()
        t0 = time.perf_counter()
        loss_cpu, lr_cpu = _train_steps(cpu, "cpu", chunk, K, recipe)
        cpu_s = time.perf_counter() - t0
        check(bool(torch.isfinite(loss_card).all()), "non-finite train loss "
                                                     "on the card")
        leaves = sum(p.requires_grad for p in card.parameters())
        want = dict.fromkeys(launched, 0)      # paged attention: none
        want.update({k: v * K for k, v in
                     launches_per_step(2, leaves, recipe).items()})
        loss_diff = float((loss_card - loss_cpu).abs().max())
        wc, wp = export_state(card), export_state(cpu)
        worst, far, total = 0.0, 0, 0
        for k in wc:
            d = np.abs(wc[k] - wp[k])
            worst = max(worst, float(d.max()))
            far += int((d > TRAIN_PARITY_LR / 10).sum())
            total += d.size
        what = ("train recipe (schedule, clip, decay filter, bf16 moments, "
                "recompute)" if recipe else "AdamW")
        emit({"phase": "model_train", "config": "gpt3-1.3b widths, 2 layers, "
              f"fp32, B=2, S=128, 3 steps, {what}",
              "loss_card": loss_card.tolist(), "loss_cpu": loss_cpu.tolist(),
              "lr_vector": lr_card.tolist(), "loss_max_abs_diff": loss_diff,
              "loss_tol": TRAIN_PARITY_LOSS_TOL,
              "grad_norm_max_rel_diff": grad_rel[worst_grad],
              "grad_norm_worst_leaf": worst_grad,
              "grad_norm_rtol": TRAIN_PARITY_GRAD_RTOL,
              "grad_norm_leaves": len(grad_rel), "param_max_abs_diff": worst,
              "param_tol": 6 * TRAIN_PARITY_LR,
              "param_share_past_lr_over_10": far / total,
              "param_share_tol": TRAIN_PARITY_SHARE, "cpu_twin_s": cpu_s,
              "kernel_launches": launched})
        check(launched == want,
              f"train parity ({what}) launched {launched}, want {want}")
        check(np.array_equal(lr_card, lr_cpu),
              f"card and CPU lr vectors differ: {lr_card} vs {lr_cpu}")
        check(grad_rel[worst_grad] <= TRAIN_PARITY_GRAD_RTOL,
              f"card vs CPU first-step gradient norm of {worst_grad} differs "
              f"by {grad_rel[worst_grad]} of itself > "
              f"{TRAIN_PARITY_GRAD_RTOL}")
        check(loss_diff <= TRAIN_PARITY_LOSS_TOL,
              f"card vs CPU train losses ({what}) differ by {loss_diff}")
        check(worst <= 6 * TRAIN_PARITY_LR
              and far / total <= TRAIN_PARITY_SHARE,
              f"card vs CPU weights after {K} steps ({what}): max diff "
              f"{worst}, share past lr/10 {far / total}")
        del cpu, card, wc, wp
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 5
SERVE_NEW_TOKENS = 32
SERVE_KERNELS = ("paged_attention", "layernorm_fwd")


def serve_workload():
    """The serve cell, shared with tools/profile_torch_serving.py: full
    gpt3-1.3b in bf16 with random weights from SEED behind
    LLMEngine(num_slots=8, block_len=8, n_blocks=64, prefill_chunk=64) on
    a MonotonicClock, and its 16 prompts of 32..400 tokens. Returns
    (model, engine, prompts, model_init_s); the engine is not started."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    model = GPTForCausalLM.from_preset("gpt3-1.3b", device="cuda",
                                       dtype="bfloat16", generator=gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = LLMEngineConfig(num_slots=8, block_len=8, n_blocks=64,
                          prefill_chunk=64, max_new_tokens=SERVE_NEW_TOKENS)
    engine = LLMEngine(model, cfg)
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(0, 50304, (int(n),)).astype(np.int32)
               for n in rng.randint(32, 401, size=16)]
    return model, engine, prompts, init_s


def serve_warm_up(engine, prompts):
    """One short request through the started engine, outside any counted
    run (cuBLAS handles, allocator growth)."""
    import torch
    engine.generate(prompts[0][:40], max_new_tokens=2, timeout=600)
    torch.cuda.synchronize()


def serve_burst(engine, prompts, logprobs=False):
    """Submit every prompt to the started engine at once and wait for every
    stream. Returns (handles, outs, wall_s, steps, decode_iterations)."""
    steps0, dec0 = engine.steps, engine.decode_iterations
    t0 = time.perf_counter()
    handles = [engine.submit(p, max_new_tokens=SERVE_NEW_TOKENS,
                             logprobs=logprobs) for p in prompts]
    outs = [h.result(timeout=900) for h in handles]
    wall = time.perf_counter() - t0
    return (handles, outs, wall, engine.steps - steps0,
            engine.decode_iterations - dec0)


def phase_serve():
    import numpy as np
    import torch
    from paddle_tpu_torch.models.generation import generate
    from paddle_tpu_torch.ops import _kernels

    model, engine, prompts, init_s = serve_workload()
    plens = [len(p) for p in prompts]
    n_compare = 4
    # the first-token logits row of each compared request, copied out of
    # the step that lands its last prompt chunk (on the scheduler thread,
    # which alone changes engine._active while the engine runs)
    watch = {prompts[i].tobytes(): i for i in range(n_compare)}
    first_logits = {}
    step_logits = engine._step_logits

    def capturing_step_logits(toks, pos, adv):
        lg = step_logits(toks, pos, adv)
        for slot, req in engine._active.items():
            i = watch.get(req.prompt.tobytes())
            if i is not None and req.chunk_off < len(req.prompt) \
                    and req.chunk_off + int(adv[slot]) == len(req.prompt):
                first_logits[i] = lg[slot, int(adv[slot]) - 1].float().cpu()
        return lg

    engine._step_logits = capturing_step_logits
    engine.start()
    try:
        serve_warm_up(engine, prompts)
        _kernels.reset_launch_counts()
        handles, outs, wall, steps, decode_iters = serve_burst(
            engine, prompts, logprobs=True)
        launches = _kernels.launch_counts()
    finally:
        engine.stop(drain=True, timeout=60)
    check(all(launches[k] > 0 for k in SERVE_KERNELS),
          f"the served path did not launch every served kernel: "
          f"{launches}")
    for o, h in zip(outs, handles):
        check(o.shape == (SERVE_NEW_TOKENS,),
              f"stream of shape {o.shape}, want ({SERVE_NEW_TOKENS},)")
        check(((o >= 0) & (o < 50304)).all(), "token id out of range")
        lps = np.asarray(h.logprobs_so_far(), np.float64)
        check(np.isfinite(lps).all() and (lps <= 0).all(),
              "non-finite or positive logprob")
    ttfts = sorted(h.ttft_ms for h in handles)
    gen_tokens = sum(len(o) for o in outs)
    engine.pool.check_balance()

    # 4 streams against the port's one-shot generate(); bitwise equality
    # is a CPU contract (cuBLAS picks algorithms by M), so token agreement
    # is reported and the first step's logits are held to a bound. Both
    # paths round every layer's activations to bf16, so another GEMM
    # grouping moves a logit (|logit| < 2 with these random weights) by a
    # few bf16 ulps of at most 2^-7 each; 2^-4 allows eight. A broken path
    # (a wrong mask, page or position) changes the hidden state wholesale
    # and moves logits by their own spread, ~0.3.
    logits_tol = 2.0 ** -4
    check(sorted(first_logits) == list(range(n_compare)),
          f"captured first-step logits of {sorted(first_logits)} only")
    compare = []
    for i in range(n_compare):
        p = prompts[i]
        ref = generate(model, p[None],
                       max_new_tokens=SERVE_NEW_TOKENS).numpy()[0, len(p):]
        o = outs[i]
        same = int((ref == o).sum())
        first_div = next((j for j in range(len(o)) if ref[j] != o[j]), None)
        # generate()'s prefill: the whole prompt in one call at pos 0
        caches = model.init_cache(1, -(-(len(p) + SERVE_NEW_TOKENS) // 8) * 8)
        with torch.no_grad():
            lg, _ = model.forward_with_cache(
                torch.from_numpy(p[None]).cuda(), caches, 0)
        lg_ref = lg[0, -1].float().cpu()
        lp_ref = torch.log_softmax(lg_ref, -1)[int(o[0])].item()
        lp_eng = handles[i].logprobs_so_far()[0]
        compare.append(dict(
            prompt_len=len(p), tokens_equal=same, first_divergence=first_div,
            first_logits_max_abs_diff=float(
                (first_logits[i] - lg_ref).abs().max()),
            first_logprob_diff=abs(lp_eng - lp_ref)))
    worst_logits = max(c["first_logits_max_abs_diff"] for c in compare)
    stats = engine.metrics.snapshot()
    result = {
        "phase": "serve", "model": "gpt3-1.3b", "dtype": "bfloat16",
        "requests": len(prompts), "prompt_lens": [int(n) for n in plens],
        "max_new_tokens": SERVE_NEW_TOKENS, "generated_tokens": gen_tokens,
        "wall_s": wall, "generated_tok_s": gen_tokens / wall,
        "ttft_p50_ms": statistics.median(ttfts),
        "ttft_p99_ms": ttfts[min(len(ttfts) - 1,
                                 int(round(0.99 * (len(ttfts) - 1))))],
        "decode_step_p50_ms": stats["intertoken_p50_ms"],
        "steps": steps, "decode_iterations": decode_iters,
        "kernel_launches": launches, "model_init_s": init_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "vs_generate": compare, "first_logits_tol": logits_tol}
    emit(result)
    check(worst_logits <= logits_tol,
          f"engine vs generate() first-step logits differ by {worst_logits} "
          f"> {logits_tol}")
    return launches


# ---------------------------------------------------------------- phase 6
TRAIN_WARMUP_STEPS = 3
TRAIN_TIMED_STEPS = 10
# launches_per_step(24, 293, recompute): gpt3-1.3b has 24 layers and 293
# parameters (12 a layer, two embeddings, the final LayerNorm's two and
# the untied lm_head), each with a gradient and one fused-Adam launch
TRAIN_KERNELS_PER_STEP = {"flash_fwd": 24, "flash_bwd_dq": 24,
                          "flash_bwd_dkv": 24, "layernorm_fwd": 49,
                          "layernorm_bwd": 49, "fused_adam": 293}
# recompute reruns every layer's forward (one flash forward, two LayerNorm
# forwards) in the backward; the final LayerNorm is outside the layers
RECIPE_KERNELS_PER_STEP = {"flash_fwd": 48, "flash_bwd_dq": 24,
                           "flash_bwd_dkv": 24, "layernorm_fwd": 97,
                           "layernorm_bwd": 49, "fused_adam": 293}
RECIPE_PEAK_LR = 2e-4


def recipe_decays(name):
    """GPT-3's weight-decay filter: neither a bias nor a LayerNorm
    parameter (`gpt.layers.0.norm1.weight`, `gpt.final_norm.bias`)."""
    return not (name.endswith(".bias") or "norm" in name)


def recipe_schedule(peak_lr):
    """GPT-3's schedule cut to the smoke's 3 + 10 steps: a linear warm-up
    from 0 over 4 steps into a cosine decay to peak/10 over 9."""
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)
    return LinearWarmup(CosineAnnealingDecay(peak_lr, T_max=9,
                                             eta_min=peak_lr / 10),
                        warmup_steps=4, start_lr=0.0, end_lr=peak_lr)


def recipe_optimizer(parameters, peak_lr):
    """GPT-3's optimizer for its 1.3B model (Brown et al. 2020, Table 2.1
    and Appendix B) with bench.py's bf16 moments: AdamW(0.9, 0.95, 1e-8),
    weight decay 0.1 through recipe_decays, global-norm clip 1.0 and
    recipe_schedule(peak_lr)."""
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    return AdamW(learning_rate=recipe_schedule(peak_lr), beta1=0.9,
                 beta2=0.95, epsilon=1e-8, parameters=parameters,
                 weight_decay=0.1, apply_decay_param_fun=recipe_decays,
                 grad_clip=ClipGradByGlobalNorm(1.0),
                 moment_dtype="bfloat16")


def train_workload(recipe=False):
    """The train cell, shared with tools/profile_torch_training.py: full
    gpt3-1.3b in bf16 with random weights from SEED, in training mode;
    AdamW(lr 1e-4, wd 0.01, fp32 moments), or with `recipe` bench.py's
    recipe (use_recompute, bf16 moments) and recipe_optimizer at
    RECIPE_PEAK_LR; one batch of B=4 x S=1024 token ids and next-token
    labels from SEED, repeated every step as bench.py repeats its batch.
    Returns (model, opt, ids, labels, model_init_s)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    model = GPTForCausalLM.from_preset("gpt3-1.3b", device="cuda",
                                       dtype="bfloat16", generator=gen,
                                       use_recompute=recipe)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model.train()
    if recipe:
        opt = recipe_optimizer(model.parameters(), RECIPE_PEAK_LR)
    else:
        opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                    parameters=model.parameters(), moment_dtype="float32")
    rng = np.random.RandomState(SEED + 4)
    ids = rng.randint(0, 50304, (TRAIN_B, TRAIN_S)).astype(np.int32)
    labels = rng.randint(0, 50304, (TRAIN_B, TRAIN_S)).astype(np.int32)
    return model, opt, ids, labels, init_s


def timed_chunk(step, ids, labels):
    """Run one chunk of `step` (a ScanTrainStep) over (ids, labels) repeated
    K times, with a CUDA event after every step. Returns (losses on the
    CPU, wall s from the call to the end of the last step, per-step
    device-timeline ms, per-step host ms). The host ms of a step runs from
    its first launch to its last; nothing in a step waits for the device,
    but the host blocks once the launch queue is full, so while the device
    is the bottleneck it reads the step time, not the host's own work."""
    import torch
    from paddle_tpu_torch.parallel import stack_batches
    K = step.scan_steps
    events = [torch.cuda.Event(enable_timing=True) for _ in range(K + 1)]
    host_ms = []
    inner = step._train_step

    def marked(*a):
        t = time.perf_counter()
        loss = inner(*a)
        host_ms.append((time.perf_counter() - t) * 1e3)
        events[len(host_ms)].record()
        return loss

    chunk = stack_batches([(ids, labels)] * K)
    torch.cuda.synchronize()
    step._train_step = marked
    try:
        t0 = time.perf_counter()
        events[0].record()
        losses = step(*chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del step._train_step
    ms = [events[i].elapsed_time(events[i + 1]) for i in range(K)]
    return losses.cpu(), wall, ms, host_ms


def phase_train(device_name, recipe=False, train_peak_gib=None):
    """The train cell (phase 6), or with `recipe` the train_recipe cell
    (phase 7), whose peak memory must stay below `train_peak_gib`.
    Returns (launch counts of the timed chunk, peak memory in GiB)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.obs.flops import peak_flops, train_flops_per_step
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.parallel import ScanTrainStep

    # an earlier phase's model held by a reference cycle (the serve phase's
    # engine) is freed only by the cyclic collector: collect it now, or the
    # peak below counts it whenever the collector has not yet run
    gc.collect()
    torch.cuda.empty_cache()
    model, opt, ids, labels, init_s = train_workload(recipe)
    n_params = sum(p.numel() for p in model.parameters())
    warm = ScanTrainStep(model, opt, scan_steps=TRAIN_WARMUP_STEPS)
    warm_losses, warm_s, _, _ = timed_chunk(warm, ids, labels)
    lr_used = list(warm.lr_vector)
    step = ScanTrainStep(model, opt, scan_steps=TRAIN_TIMED_STEPS)
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    losses, wall, step_ms, _ = timed_chunk(step, ids, labels)
    launches = _kernels.launch_counts()
    lr_used += list(step.lr_vector)
    want_launches = RECIPE_KERNELS_PER_STEP if recipe \
        else TRAIN_KERNELS_PER_STEP
    per_step = {k: launches[k] / TRAIN_TIMED_STEPS for k in want_launches}
    tokens = TRAIN_B * TRAIN_S * TRAIN_TIMED_STEPS
    step_s = wall / TRAIN_TIMED_STEPS
    all_losses = warm_losses.tolist() + losses.tolist()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    what = ("AdamW(0.9, 0.95, 1e-8) wd 0.1 but biases and LayerNorms, "
            "bf16 moments, global-norm clip 1.0, LinearWarmup(4 steps, 0 -> "
            f"{RECIPE_PEAK_LR}) into CosineAnnealingDecay(T_max 9, eta_min "
            f"{RECIPE_PEAK_LR / 10}); use_recompute" if recipe else
            "AdamW lr 1e-4 wd 0.01 fp32 moments")
    result = {
        "phase": "train_recipe" if recipe else "train", "model": "gpt3-1.3b",
        "dtype": "bfloat16", "batch": TRAIN_B, "seq": TRAIN_S,
        "optimizer": what, "n_params": n_params,
        "warmup_steps": TRAIN_WARMUP_STEPS, "warmup_s": warm_s,
        "timed_steps": TRAIN_TIMED_STEPS, "wall_s": wall,
        "tokens_per_s": tokens / wall, "step_ms_mean": step_s * 1e3,
        "step_ms_median": statistics.median(step_ms),
        "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
        "mfu": train_flops_per_step(n_params, TRAIN_B * TRAIN_S) / step_s
        / peak_flops(device_name),
        "peak_mem_gib": peak_gib,
        "loss_first": all_losses[0], "loss_last": all_losses[-1],
        "losses": all_losses, "lr_vector": [float(x) for x in lr_used],
        "kernel_launches": launches,
        "launches_per_step": per_step, "model_init_s": init_s,
        "dispatch_count": warm.dispatch_count + step.dispatch_count}
    emit(result)
    check(all(math.isfinite(x) for x in all_losses), "non-finite loss")
    check(all_losses[-1] < all_losses[0],
          f"loss did not fall: {all_losses[0]} -> {all_losses[-1]}")
    check(per_step == {k: float(v) for k, v in want_launches.items()},
          f"launches per step {per_step}, want {want_launches}")
    check(not any(launches[k] for k in _kernels.FLASH_VARIANTS),
          f"the train step launched a mask or dropout variant: {launches}")
    if recipe:
        host = recipe_schedule(RECIPE_PEAK_LR)
        want_lr = []
        for _ in lr_used:
            want_lr.append(host())
            host.step()
        check(np.array_equal(np.asarray(lr_used, np.float32),
                             np.asarray(want_lr, np.float32)),
              f"lr vector {lr_used}, the schedule on the host {want_lr}")
        check(peak_gib < train_peak_gib,
              f"recipe peak memory {peak_gib} GiB is not below the train "
              f"phase's {train_peak_gib} GiB")
    del model, opt, warm, step
    torch.cuda.empty_cache()
    return launches, peak_gib


KERNEL_META = {
    "paged_attention": dict(
        source="paddle_tpu_torch/csrc/paged_attention_tc.cu",
        replaces="paddle_tpu/ops/paged_attention.py:136", phase="serve"),
    "layernorm_fwd": dict(
        source="paddle_tpu_torch/csrc/layernorm.cu",
        replaces="paddle_tpu/ops/layernorm.py:35", phase="serve"),
    "flash_fwd": dict(
        source="paddle_tpu_torch/csrc/flash_attention_tc.cu",
        replaces="paddle_tpu/ops/attention.py:174", phase="train"),
    "flash_bwd_dq": dict(
        source="paddle_tpu_torch/csrc/flash_attention_tc.cu",
        replaces="paddle_tpu/ops/attention.py:246", phase="train"),
    "flash_bwd_dkv": dict(
        source="paddle_tpu_torch/csrc/flash_attention_tc.cu",
        replaces="paddle_tpu/ops/attention.py:300", phase="train"),
    "layernorm_bwd": dict(
        source="paddle_tpu_torch/csrc/layernorm.cu",
        replaces="paddle_tpu/ops/layernorm.py:48", phase="train"),
    "fused_adam": dict(
        source="paddle_tpu_torch/csrc/fused_adam.cu",
        replaces="paddle_tpu/ops/fused_adam.py:47", phase="train_recipe"),
    # the mask and dropout variants of kernels 3-5 (the TPU kernels'
    # has_mask and dropout_p > 0 branches)
    **{f"{k}_{v}": dict(
        source="paddle_tpu_torch/csrc/flash_attention_tc.cu",
        replaces=f"paddle_tpu/ops/attention.py:{line}",
        phase="attention_variants")
       for k, line in (("flash_fwd", 174), ("flash_bwd_dq", 246),
                       ("flash_bwd_dkv", 300))
       for v in ("mask", "dropout")},
}


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "paddle_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository "
              "(paddle_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    name, count, smi_line = phase_device()
    phase_build()
    kern = phase_kernels()
    kern.update(phase_train_kernels())
    kern.update(phase_adam_kernel())
    variants, variant_launches = phase_attention_variants()
    kern.update(variants)
    phase_model()
    phase_model_train()
    by_phase = {"attention_variants": variant_launches,
                "serve": phase_serve()}
    by_phase["train"], train_peak = phase_train(name)
    by_phase["train_recipe"], _ = phase_train(name, recipe=True,
                                              train_peak_gib=train_peak)
    keys = ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    lines = []
    for k in KERNEL_META:
        line = dict(name=k, route="cuda", **KERNEL_META[k],
                    launches=by_phase[KERNEL_META[k]["phase"]][k],
                    launches_by_phase={ph: c[k] for ph, c in
                                       by_phase.items()},
                    **{x: kern[k][x] for x in keys}, kernel_ms=kern[k]["ms"])
        for x in ("tflops", "share_of_bound", "without_variant_ms",
                  "causal_case_b", "entry_key_padding_b11s",
                  "entry_per_head_bf16"):   # the flash kernels and variants
            if x in kern[k]:
                line[x] = kern[k][x]
        if k + "_train" in kern:   # a served kernel the train step runs too
            line["at_train_shape"] = {
                x: kern[k + "_train"][x] for x in
                keys + ("shape", "share_of_bound", "cold_ms",
                        "cold_library_ms", "cold_share_of_bound")}
        lines.append(line)
    emit({"kernels": lines})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
