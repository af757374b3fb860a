"""Build, load and count the port's hand-written CUDA kernels.

The sources under `paddle_tpu_torch/csrc/*.cu` have a plain C interface.
At first use they are compiled for Hopper (`-gencode
arch=compute_90a,code=sm_90a`) with one `nvcc` per source, all started
together, linked into one shared library, and loaded with ctypes. The
library goes into `build/paddle_tpu_torch/` at the root of the checkout
(or `$PADDLE_TPU_TORCH_BUILD_DIR`), named by a hash of every file under
`csrc/` (the sources and the headers they include) and the flags, so a
changed source or header rebuilds and an unchanged tree loads at once.

Nothing here runs at import: the CPU tests import every module, and the
CPU path never needs the compiler.

Every wrapper that launches a kernel adds one to `LAUNCHES[name]` right
after the launch succeeds, and nowhere else; `reset_launch_counts()` and
`launch_counts()` let a run show that its main path went through the
kernels.

The build is the port's only compile: `add_build_listener(fn)` has
`fn(seconds)` called after each build this process runs (the goodput
ledger's recompile sentinel books it as `compile`); loading a library
already built is no compile.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("flash_attention.cu", "flash_attention_tc.cu", "fused_adam.cu",
           "layernorm.cu", "paged_attention.cu", "paged_attention_tc.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

# the flash kernels' mask and dropout variants count apart from the plain
# (causal or not) instantiation the train step runs
FLASH_VARIANTS = tuple(f"{k}{v}" for k in ("flash_fwd", "flash_bwd_dq",
                                            "flash_bwd_dkv")
                       for v in ("_mask", "_dropout"))
# the fp16 instantiations (AMP in float16, pure-fp16 O2 training, fp16
# serving) count apart from the fp32 and bf16 ones: a kernel's name plus
# FP16_SUFFIX (`fp16_name`)
FP16_SUFFIX = "_fp16"
FLASH_FP16 = ("flash_fwd_fp16", "flash_bwd_dq_fp16", "flash_bwd_dkv_fp16")
FLASH_VARIANTS_FP16 = tuple(k + FP16_SUFFIX for k in FLASH_VARIANTS)
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "layernorm_fwd",
           "layernorm_bwd", "paged_attention", "fused_adam")
FP16 = (FLASH_FP16 + FLASH_VARIANTS_FP16
        + tuple(k + FP16_SUFFIX for k in KERNELS[3:]))
LAUNCHES = {**dict.fromkeys(KERNELS, 0),
            **dict.fromkeys(FLASH_VARIANTS, 0),
            **dict.fromkeys(FP16, 0)}
# paged-attention launches by the route the library took (its own rule,
# asked at each launch): "<counter>:<route>", e.g.
# "paged_attention_fp16:tensor_cores"
ROUTE_LAUNCHES = {f"{k}:{r}": 0
                  for k in ("paged_attention", "paged_attention_fp16")
                  for r in ("tensor_cores", "scalar")}

_LIB = None
_LOCK = threading.Lock()
_BUILD_LISTENERS = []   # fn(seconds) after each build (obs.goodput)
build_seconds = None   # wall time of the last build in this process (None:
#                        the library was already built)
ptxas_report = ""      # nvcc/ptxas output of the last build: registers,
#                        shared memory and spills of every kernel
library_path = None    # the loaded library's file

_c = ctypes
_P = _c.c_void_p
# a flash kernel's variant: mask rows (fp32 [rows, Sq, Sk]) or null, the
# batch*head -> row divisor, the dropout seed and dropout_p (a double, so
# the kernel's threshold is int(p * (2**32 - 1)) as on the host)
_VARIANT = (_P, _c.c_int, _c.c_ulonglong, _c.c_double)
_SIGNATURES = {
    # x, w, b, y, mu, rstd, R, N, eps, dtype, stream
    "pdtt_layernorm_fwd": (_P, _P, _P, _P, _P, _P, _c.c_longlong, _c.c_int,
                           _c.c_float, _c.c_int, _P),
    # x, w, mu, rstd, dy, dx, dw, db, part, R, N, rows_per_cta, dtype,
    # stream
    "pdtt_layernorm_bwd": (_P,) * 9 + (_c.c_longlong, _c.c_int, _c.c_int,
                                       _c.c_int, _P),
    # q, k, v, out, lse, BH, Sq, Sk, D, scale, causal, then the variant
    # (mask rows or 0, mask row divisor, seed, dropout_p), dtype, stream
    "pdtt_flash_fwd": (_P,) * 5 + (_c.c_int,) * 4 + (_c.c_float, _c.c_int)
                      + _VARIANT + (_c.c_int, _P),
    # q, k, v, g, lse, delta, dq, BH, Sq, Sk, D, scale, causal, variant,
    # dtype, stream
    "pdtt_flash_bwd_dq": (_P,) * 7 + (_c.c_int,) * 4 + (_c.c_float,
                                                        _c.c_int)
                         + _VARIANT + (_c.c_int, _P),
    # q, k, v, g, lse, delta, dk, dv, BH, Sq, Sk, D, scale, causal,
    # variant, dtype, stream
    "pdtt_flash_bwd_dkv": (_P,) * 8 + (_c.c_int,) * 4 + (_c.c_float,
                                                         _c.c_int)
                          + _VARIANT + (_c.c_int, _P),
    # keep (bool [BH, Sq, Sk]), BH, Sq, Sk, seed, dropout_p, stream
    "pdtt_dropout_keep_mask": (_P,) + (_c.c_int,) * 3
                              + (_c.c_ulonglong, _c.c_double, _P),
    # q, k, v, table, seq_lens, q_pos, out, B, H, Tq, D, Hkv, L_slab,
    # n_blocks, block_len, pages_per_row, scale, dtype, stream
    "pdtt_paged_attention": (_P, _P, _P, _P, _P, _P, _P) + (_c.c_int,) * 9
                            + (_c.c_float, _c.c_int, _P),
    # dtype, block_len, D: 1 where pdtt_paged_attention takes the
    # tensor-core kernel, else 0
    "pdtt_paged_attention_route": (_c.c_int,) * 3,
    # p, g, m1, m2, master, lr, b1p, b2p, do_update (bool or null), n, b1,
    # 1-b1, b2, 1-b2, eps, wd, decoupled, p dtype, g dtype, moment dtype,
    # stream
    "pdtt_fused_adam": (_P,) * 9 + (_c.c_longlong,) + (_c.c_float,) * 6
                       + (_c.c_int,) * 4 + (_P,),
}


def reset_launch_counts():
    for counts in (LAUNCHES, ROUTE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def route_counts() -> dict:
    return dict(ROUTE_LAUNCHES)


def add_build_listener(fn):
    """Call `fn(seconds)` after every build of the library in this
    process; idempotent."""
    with _LOCK:
        if fn not in _BUILD_LISTENERS:
            _BUILD_LISTENERS.append(fn)


def remove_build_listener(fn):
    with _LOCK:
        if fn in _BUILD_LISTENERS:
            _BUILD_LISTENERS.remove(fn)


def _build_dir() -> Path:
    env = os.environ.get("PADDLE_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "paddle_tpu_torch"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from source at first use")


def _source_key(flags) -> str:
    """Hash of every source and header under CSRC and the flags: an
    edited header changes it as an edited source does."""
    h = hashlib.sha256()
    for path in sorted(p for p in CSRC.iterdir()
                       if p.suffix in (".cu", ".cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _build(out: Path, flags):
    """One nvcc -c per source, all started together, then one link. The
    library is written under a temporary name and renamed into place, so
    concurrent builders never load a half-written file."""
    global build_seconds, ptxas_report
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *flags, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        report = []
        failed = []
        for name, _obj, p in procs:
            text, _ = p.communicate()
            report.append(f"== {name}\n{text}")
            if p.returncode != 0:
                failed.append(f"{name} (exit {p.returncode}):\n{text}")
        if failed:
            raise RuntimeError("nvcc failed to build the port's kernels:\n"
                               + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        link = [nvcc, "-shared", "-o", str(tmp_lib),
                *[str(obj) for _, obj, _ in procs], "-lcudart"]
        r = subprocess.run(link, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"linking the port's kernels failed:\n"
                               f"{r.stdout}")
        os.replace(tmp_lib, out)
    build_seconds = time.perf_counter() - t0
    ptxas_report = "\n".join(report)


def load_library():
    """The loaded kernel library, building it first when needed."""
    global _LIB, library_path
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out = _build_dir() / (
            f"libpdtt_kernels_{_source_key(NVCC_FLAGS)}.so")
        built = not out.exists()
        if built:
            _build(out, NVCC_FLAGS)
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LIB = lib
        library_path = out
        listeners = list(_BUILD_LISTENERS) if built else []
    for fn in listeners:
        fn(build_seconds)
    return _LIB


def sass_instruction_counts(opcodes=("HMMA", "HGMMA")) -> dict:
    """{kernel symbol: {opcode: count}} in the loaded library's machine
    code (`cuobjdump -sass`), for every kernel that has one of `opcodes`:
    the proof that a kernel runs on the tensor cores."""
    load_library()
    tool = Path(_nvcc()).with_name("cuobjdump")
    r = subprocess.run([str(tool), "-sass", str(library_path)],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed:\n{r.stdout}")
    return count_sass_opcodes(r.stdout, opcodes)


def count_sass_opcodes(sass: str, opcodes) -> dict:
    """Count the instructions of `opcodes` (with any modifiers, as in
    `HGMMA.64x64x16.F32.BF16`) under each `Function :` of a cuobjdump -sass
    listing; functions without any are left out."""
    counts, fn = {}, None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function : "):
            fn = line[len("Function : "):]
            continue
        if fn is None:
            continue
        for op in opcodes:
            if f" {op}." in line or f" {op} " in line:
                counts.setdefault(fn, dict.fromkeys(opcodes, 0))[op] += 1
    return counts


def ptxas_kernel_stats(report: str) -> dict:
    """{kernel symbol: {"registers", "spill_stores", "spill_loads"}} from
    `nvcc -Xptxas -v` output (`ptxas_report`)."""
    stats, fn = {}, None
    for line in report.splitlines():
        if "Compiling entry function '" in line:
            fn = line.split("'")[1]
            stats[fn] = {"registers": None, "spill_stores": 0,
                         "spill_loads": 0}
        elif "Function properties for " in line:
            # a non-inlined device function's properties are not a kernel's
            name = line.split("Function properties for ")[1].strip()
            fn = name if name in stats else None
        elif fn is None:
            continue
        elif "bytes spill stores" in line:
            words = line.replace(",", " ").split()
            stats[fn]["spill_stores"] = int(words[words.index("spill") - 2])
            stats[fn]["spill_loads"] = int(words[-4])
        elif "Used " in line and " registers" in line:
            words = line.split()
            stats[fn]["registers"] = int(words[words.index("Used") + 1])
    return stats


def dtype_code(dtype) -> int:
    """The C entry points' dtype code: 0 float32, 1 bfloat16, 2 float16
    (every kernel takes all three, as the JAX kernels take any float
    dtype). Raises TypeError on anything else."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    if dtype not in codes:
        raise TypeError(f"the port's CUDA kernels take float32, bfloat16 or "
                        f"float16, got {dtype}")
    return codes[dtype]


def fp16_name(name, *dtypes) -> str:
    """The launch counter of kernel `name` for operands of `dtypes`: its
    fp16 instantiation's (name + FP16_SUFFIX) where any operand is
    float16, else `name`."""
    import torch
    return name + FP16_SUFFIX if torch.float16 in dtypes else name


def current_stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(rc: int, what: str):
    """Raise on a non-zero cudaGetLastError() from a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc} "
                           "(see cuda_runtime_api.h for the code)")
