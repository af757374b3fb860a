#!/usr/bin/env python3
"""Time other launch configurations of the LayerNorm kernels on the card.

    python3 tools/sweep_layernorm.py [--out build/ln_sweep/sweep.json]

Run from the root of a checkout on a machine with an NVIDIA H100 and nvcc.
Each variant is `paddle_tpu_torch/csrc/layernorm.cu` with one entry of
its instantiation tables changed: the bf16 forward's entry for
1025 <= N <= 2048 (threads a row x 16-byte packs a thread) and the
forward's CTA size, or the bf16 backward's entry for 1025 <= N <= 2048
(threads a row x packs x rows a batch x shared-memory stages). Every
variant is built into its own library under build/ln_sweep/ (one nvcc
each, all started together), held against the plain PyTorch version at
chip_smoke.py's limits, and timed with chip_smoke.time_cuda at the
served (512x2048) and trained (4096x2048) bf16 shapes: the forward warm
and with its input and output cycled past L2 over chip_smoke.L2_COPIES
copies, the backward at 4096x2048 over two copies (as chip_smoke.py
times it) and also at other numbers of partial rows G, which the wrapper
chooses (no rebuild). In the same run: F.layer_norm's forward and
backward; a copy and an add with the kernels' bytes (what an elementwise
pass reaches on the card); the backward's two kernels split by
torch.profiler; and fp32 dw/db over 70001 rows against an fp64 sum.
Prints one JSON line per reading and writes them all to --out.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs                                    # noqa: E402
from paddle_tpu_torch.ops import _kernels                   # noqa: E402

SOURCE = ROOT / "paddle_tpu_torch" / "csrc" / "layernorm.cu"
BUILD = ROOT / "build" / "ln_sweep"
EPS = 1e-5

# name -> (table, entry replaced, its replacement, forward CTA threads)
FWD_DEFAULT = "X(128, 2)"
BWD_DEFAULT = "X(256, 1, 2, 3)"
VARIANTS = {
    "fwd_32x8_cta128": ("PDTT_LN_FWD_BF16", FWD_DEFAULT, "X(32, 8)", 128),
    "fwd_64x4_cta128": ("PDTT_LN_FWD_BF16", FWD_DEFAULT, "X(64, 4)", 128),
    "fwd_128x2_cta128": ("PDTT_LN_FWD_BF16", FWD_DEFAULT, FWD_DEFAULT, 128),
    "fwd_128x2_cta256": ("PDTT_LN_FWD_BF16", FWD_DEFAULT, FWD_DEFAULT, 256),
    "fwd_256x1_cta256": ("PDTT_LN_FWD_BF16", FWD_DEFAULT, "X(256, 1)", 256),
    "bwd_256x1_k2_s3": ("PDTT_LN_BWD_BF16", BWD_DEFAULT, BWD_DEFAULT, 128),
    "bwd_256x1_k2_s2": ("PDTT_LN_BWD_BF16", BWD_DEFAULT, "X(256, 1, 2, 2)",
                        128),
    "bwd_256x1_k4_s2": ("PDTT_LN_BWD_BF16", BWD_DEFAULT, "X(256, 1, 4, 2)",
                        128),
    "bwd_256x1_k1_s4": ("PDTT_LN_BWD_BF16", BWD_DEFAULT, "X(256, 1, 1, 4)",
                        128),
    "bwd_128x2_k2_s3": ("PDTT_LN_BWD_BF16", BWD_DEFAULT, "X(128, 2, 2, 3)",
                        128),
}
BWD_DEFAULT_NAME = "bwd_256x1_k2_s3"
BWD_CTAS = (132, 264, 396)      # partial rows G tried with the default


def variant_source(table, old, new, cta):
    """layernorm.cu with `old` replaced by `new` in `table` and the
    forward's CTA size set to `cta`."""
    src = SOURCE.read_text()
    m = re.search(rf"#define {table}\(X\)((?:[^\n]*\\\n)*[^\n]*)", src)
    body = m.group(1)
    assert body.count(old) == 1, (table, old)
    src = src.replace(body, body.replace(old, new))
    src, n = re.subn(r"constexpr int kFwdThreads = \d+;",
                     f"constexpr int kFwdThreads = {cta};", src)
    assert n == 1
    return src


def build_all():
    """{variant: loaded library}; every nvcc runs at once."""
    nvcc = _kernels._nvcc()
    procs = {}
    for name, spec in VARIANTS.items():
        d = BUILD / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "layernorm.cu").write_text(variant_source(*spec))
        cmd = [nvcc, *_kernels.NVCC_FLAGS, "-shared", str(d / "layernorm.cu"),
               "-o", str(d / "liblnsweep.so"), "-lcudart"]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs, reports = {}, {}
    for name, p in procs.items():
        out, _ = p.communicate()
        cs.check(p.returncode == 0, f"nvcc failed for {name}:\n{out}")
        stats = _kernels.ptxas_kernel_stats(out)
        reports[name] = {k: v for k, v in stats.items()
                         if "I13__nv_bfloat16Lb1E" in k}
        lib = ctypes.CDLL(str(BUILD / name / "liblnsweep.so"))
        for fn in ("pdtt_layernorm_fwd", "pdtt_layernorm_bwd"):
            getattr(lib, fn).argtypes = list(_kernels._SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, reports


def fwd_call(lib, x, w, b):
    """A forward launch of `lib` on x [R, N] bf16 into outputs made once."""
    import torch
    R, N = x.shape
    y = torch.empty_like(x)
    mu = torch.empty((R, 1), device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mu)
    stream = _kernels.current_stream_handle(x.device)

    def call():
        rc = lib.pdtt_layernorm_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                    y.data_ptr(), mu.data_ptr(),
                                    rstd.data_ptr(), R, N, EPS, 1, stream)
        _kernels.check_launch(rc, "layernorm_fwd (sweep)")
    return call, (y, mu, rstd)


def bwd_call(lib, x, w, mu, rstd, dy, ctas):
    import torch
    R, N = x.shape
    rows = -(-R // ctas)
    G = -(-R // rows)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    db = torch.empty_like(w)
    part = torch.empty((2, G, N), device=x.device, dtype=torch.float32)
    stream = _kernels.current_stream_handle(x.device)

    def call():
        rc = lib.pdtt_layernorm_bwd(
            x.data_ptr(), w.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
            part.data_ptr(), R, N, rows, 1, stream)
        _kernels.check_launch(rc, "layernorm_bwd (sweep)")
    return call, (dx, dw, db)


def check_fwd(torch, name, got, x, w, b):
    from paddle_tpu_torch.ops.layernorm import layer_norm_fwd_plain
    torch.cuda.synchronize()
    y_ref, mu_ref, rstd_ref = layer_norm_fwd_plain(x, w, b, EPS)
    y, mu, rstd = got
    big = torch.maximum(y.float().abs(), y_ref.float().abs())
    cs.check(bool(((y.float() - y_ref.float()).abs()
                   <= cs.ulp_bf16(big) + 1e-5).all()),
             f"{name}: y past one bf16 ulp + 1e-5 of the plain version")
    cs.check(float((mu - mu_ref).abs().max()) <= 1e-5
             and float(((rstd - rstd_ref) / rstd_ref).abs().max()) <= 1e-5,
             f"{name}: mean or rstd past 1e-5")


def check_bwd(torch, name, got, x, w, mu, rstd, dy):
    from paddle_tpu_torch.ops.layernorm import layer_norm_bwd_plain
    torch.cuda.synchronize()
    ref = layer_norm_bwd_plain(x, w, mu, rstd, dy)
    ref32 = layer_norm_bwd_plain(x.float(), w.float(), mu, rstd, dy.float())
    for n, a, r, r32 in zip(("dx", "dw", "db"), got, ref, ref32):
        err_k, err_p, limit = cs.bf16_vs_fp32_plain(torch, a, r, r32)
        cs.check(err_k <= limit, f"{name} {n}: error {err_k} past {limit}")


def yardsticks(torch, emit, x, dy, w, b, N):
    """Plain PyTorch elementwise calls that move the kernels' bytes, with
    their inputs cycled past L2: a copy of x (the forward's read and
    write) and x + dy into a third tensor (the backward's two reads and
    one write). What an elementwise pass reaches on this card."""
    R = x.shape[0]
    xs = [x] + [x.clone() for _ in range(cs.L2_COPIES - 1)]
    ys = [torch.empty_like(x) for _ in xs]
    copy_ms, _ = cs.time_cuda([partial(y_.copy_, x_) for x_, y_ in
                               zip(xs, ys)])
    dys = [dy] + [dy.clone() for _ in range(cs.L2_COPIES - 1)]
    add_ms, _ = cs.time_cuda([partial(torch.add, x_, d_, out=y_)
                              for x_, d_, y_ in zip(xs, dys, ys)])
    emit({"kernel": "yardstick copy_ (x -> y)", "R": R, "N": N,
          "cold_ms": copy_ms, "bytes": 2 * x.numel() * 2,
          "TB_s": 2 * x.numel() * 2 / copy_ms / 1e9})
    emit({"kernel": "yardstick add (x + dy -> y)", "R": R, "N": N,
          "cold_ms": add_ms, "bytes": 3 * x.numel() * 2,
          "TB_s": 3 * x.numel() * 2 / add_ms / 1e9})


def backward_split(torch, emit, x, w, mu, rstd, dy):
    """Device time of the backward's two kernels (pass 1 and the partials'
    sum), from torch.profiler over 20 calls of the library's backward."""
    from paddle_tpu_torch.ops.layernorm import layer_norm_bwd_cuda
    for _ in range(3):
        layer_norm_bwd_cuda(x, w, mu, rstd, dy)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(20):
            layer_norm_bwd_cuda(x, w, mu, rstd, dy)
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if "layernorm" in e.key:
            dev = getattr(e, "device_time_total", None)
            if dev is None:
                dev = e.cuda_time_total
            split[e.key[:90]] = dev / 1e3 / max(e.count, 1)
    emit({"kernel": "backward split (ms a call)", "split": split})


def fp32_sum_errors(torch, emit, gen, R=70001, N=1000):
    """dw and db of an fp32 backward over R rows: the kernel's and the
    plain version's largest error from an fp64 sum of the same terms, at
    the wrapper's rows a CTA and at 64."""
    from paddle_tpu_torch.ops import layernorm as ln
    x = torch.randn(R, N, generator=gen, device="cuda") * 3 + 0.5
    w, b = (torch.randn(N, generator=gen, device="cuda") for _ in range(2))
    dy = torch.randn(R, N, generator=gen, device="cuda")
    _, mu, rstd = ln.layer_norm_fwd_cuda(x, w, b, EPS)
    xhat = (x.double() - mu.double()) * rstd.double()
    ref = ((dy.double() * xhat).sum(0), dy.double().sum(0))
    plain = ln.layer_norm_bwd_plain(x, w, mu, rstd, dy)[1:]
    lib = _kernels.load_library()
    res = {"plain": [float((p.double() - r).abs().max())
                     for p, r in zip(plain, ref)]}
    for rows in (ln._bwd_rows_per_cta(R), 64):
        G = -(-R // rows)
        dx, dw, db = (torch.empty_like(t) for t in (x, w, w))
        part = torch.empty((2, G, N), device="cuda", dtype=torch.float32)
        rc = lib.pdtt_layernorm_bwd(
            x.data_ptr(), w.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
            part.data_ptr(), R, N, rows, 0,
            _kernels.current_stream_handle(x.device))
        _kernels.check_launch(rc, "layernorm_bwd")
        res[f"kernel_rows_{rows}"] = [float((k.double() - r).abs().max())
                                      for k, r in zip((dw, db), ref)]
        res[f"kernel_rows_{rows}_vs_plain"] = [
            float((k - p).abs().max()) for k, p in zip((dw, db), plain)]
    emit({"kernel": "fp32 dw/db error from fp64 [dw, db]", "R": R, "N": N,
          **res})


def main():
    import torch
    import torch.nn.functional as F
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/ln_sweep/sweep.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_layernorm: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    libs, ptxas = build_all()
    lines = [{"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "build_s": time.perf_counter() - t0}]

    def emit(d):
        lines.append(d)
        print(json.dumps(d), flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    N = 2048
    w, b = (torch.randn(N, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    shapes = {}
    for R in (512, 4096):
        x = (torch.randn(R, N, generator=gen, device="cuda") * 3
             + 0.5).to(torch.bfloat16)
        shapes[R] = [x] + [x.clone() for _ in range(cs.L2_COPIES - 1)]
    for R, xs in shapes.items():
        el = 2
        bound, _ = cs.bound_ms(2 * R * N * el + 2 * N * el + 2 * R * 4,
                               8 * R * N, "bfloat16")
        lib_warm, _ = cs.time_cuda([partial(F.layer_norm, xs[0], (N,), w, b,
                                            EPS)])
        lib_cold, _ = cs.time_cuda([partial(F.layer_norm, x_, (N,), w, b, EPS)
                                    for x_ in xs])
        emit({"kernel": "F.layer_norm", "R": R, "N": N, "ms": lib_warm,
              "cold_ms": lib_cold, "bound_ms": bound})
        for name, lib in libs.items():
            if not name.startswith("fwd"):
                continue
            calls = [fwd_call(lib, x_, w, b) for x_ in xs]
            calls[0][0]()
            check_fwd(torch, name, calls[0][1], xs[0], w, b)
            warm, _ = cs.time_cuda([calls[0][0]])
            cold, _ = cs.time_cuda([c for c, _ in calls])
            emit({"kernel": name, "R": R, "N": N, "ms": warm,
                  "cold_ms": cold, "bound_ms": bound,
                  "cold_share_of_bound": bound / cold,
                  "ptxas": ptxas[name]})
            del calls

    R = 4096
    from paddle_tpu_torch.ops import layernorm as ln
    from paddle_tpu_torch.ops.layernorm import layer_norm_fwd_cuda
    x = shapes[R][0]
    del shapes
    dy = torch.randn(R, N, generator=gen, device="cuda").to(torch.bfloat16)
    _, mu, rstd = layer_norm_fwd_cuda(x, w, b, EPS)
    ins = [(x, dy), (x.clone(), dy.clone())]
    bound, _ = cs.bound_ms(3 * R * N * 2 + N * 2 + 2 * R * 4 + 2 * N * 2,
                           13 * R * N, "bfloat16")
    lib_ms, _ = cs.time_cuda([cs._ln_bwd_call(torch, F, x_, w, b, dy_)
                              for x_, dy_ in ins])
    emit({"kernel": "F.layer_norm backward", "R": R, "N": N, "ms": lib_ms,
          "bound_ms": bound})
    for name, lib in libs.items():
        if not name.startswith("bwd"):
            continue
        for ctas in (BWD_CTAS if name == BWD_DEFAULT_NAME else
                     (ln.BWD_TARGET_CTAS,)):
            calls = [bwd_call(lib, x_, w, mu, rstd, dy_, ctas)
                     for x_, dy_ in ins]
            calls[0][0]()
            check_bwd(torch, name, calls[0][1], x, w, mu, rstd, dy)
            ms, _ = cs.time_cuda([c for c, _ in calls])
            emit({"kernel": name, "R": R, "N": N, "target_ctas": ctas,
                  "ms": ms, "bound_ms": bound, "share_of_bound": bound / ms,
                  "ptxas": ptxas[name]})
            del calls
    yardsticks(torch, emit, x, dy, w, b, N)
    backward_split(torch, emit, x, w, mu, rstd, dy)
    fp32_sum_errors(torch, emit, gen)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
