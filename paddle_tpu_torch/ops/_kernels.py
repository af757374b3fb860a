"""Build, load and count the port's hand-written CUDA kernels.

The sources under `paddle_tpu_torch/csrc/*.cu` have a plain C interface.
At first use they are compiled for Hopper (`-gencode
arch=compute_90a,code=sm_90a`) with one `nvcc` per source, all started
together, linked into one shared library, and loaded with ctypes. The
library goes into `build/paddle_tpu_torch/` at the root of the checkout
(or `$PADDLE_TPU_TORCH_BUILD_DIR`), named by a hash of the sources and
flags, so a changed source rebuilds and an unchanged one loads at once.

Nothing here runs at import: the CPU tests import every module, and the
CPU path never needs the compiler.

Every wrapper that launches a kernel adds one to `LAUNCHES[name]` right
after the launch succeeds, and nowhere else; `reset_launch_counts()` and
`launch_counts()` let a run show that its main path went through the
kernels.
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
SOURCES = ("flash_attention.cu", "layernorm.cu", "paged_attention.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "layernorm_fwd": 0, "layernorm_bwd": 0,
            "paged_attention": 0}

_LIB = None
_LOCK = threading.Lock()
build_seconds = None   # wall time of the last build in this process (None:
#                        the library was already built)
ptxas_report = ""      # nvcc/ptxas output of the last build: registers,
#                        shared memory and spills of every kernel

_c = ctypes
_P = _c.c_void_p
_SIGNATURES = {
    # x, w, b, y, mu, rstd, R, N, eps, dtype, stream
    "pdtt_layernorm_fwd": (_P, _P, _P, _P, _P, _P, _c.c_longlong, _c.c_int,
                           _c.c_float, _c.c_int, _P),
    # x, w, mu, rstd, dy, dx, dw, db, part, R, N, rows_per_cta, dtype,
    # stream
    "pdtt_layernorm_bwd": (_P,) * 9 + (_c.c_longlong, _c.c_int, _c.c_int,
                                       _c.c_int, _P),
    # q, k, v, out, lse, BH, Sq, Sk, D, scale, causal, dtype, stream
    "pdtt_flash_fwd": (_P,) * 5 + (_c.c_int,) * 4 + (_c.c_float, _c.c_int,
                                                     _c.c_int, _P),
    # q, k, v, g, lse, delta, dq, BH, Sq, Sk, D, scale, causal, dtype,
    # stream
    "pdtt_flash_bwd_dq": (_P,) * 7 + (_c.c_int,) * 4 + (_c.c_float,
                                                        _c.c_int, _c.c_int,
                                                        _P),
    # q, k, v, g, lse, delta, dk, dv, BH, Sq, Sk, D, scale, causal, dtype,
    # stream
    "pdtt_flash_bwd_dkv": (_P,) * 8 + (_c.c_int,) * 4 + (_c.c_float,
                                                         _c.c_int, _c.c_int,
                                                         _P),
    # q, k, v, table, seq_lens, q_pos, out, B, H, Tq, D, Hkv, L_slab,
    # n_blocks, block_len, pages_per_row, scale, dtype, stream
    "pdtt_paged_attention": (_P, _P, _P, _P, _P, _P, _P) + (_c.c_int,) * 9
                            + (_c.c_float, _c.c_int, _P),
}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


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
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
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
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out = _build_dir() / (
            f"libpdtt_kernels_{_source_key(NVCC_FLAGS)}.so")
        if not out.exists():
            _build(out, NVCC_FLAGS)
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def dtype_code(dtype) -> int:
    import torch
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"the port's CUDA kernels take float32 or bfloat16, "
                    f"got {dtype}")


def current_stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(rc: int, what: str):
    """Raise on a non-zero cudaGetLastError() from a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc} "
                           "(see cuda_runtime_api.h for the code)")
