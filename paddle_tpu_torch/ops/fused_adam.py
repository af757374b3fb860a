"""Single-pass Adam update (counterpart of paddle_tpu/ops/fused_adam.py).

The TPU kernel `_adam_kernel` becomes the hand-written CUDA kernel in
`csrc/fused_adam.cu`: one flat pass over a parameter that reads p, g, m1
and m2, does `_adam_math`'s arithmetic in fp32 and writes p, m1 and m2
back in place. p, g and the moments each keep their storage dtype (fp32,
bf16 or fp16, as the JAX kernel takes any float dtype; a 16-bit value is
read, widened, and the fp32 result rounded once), and an optional fp32
master weight (`multi_precision`) is updated and the bf16 or fp16
parameter written from it. A launch with any fp16 operand counts as
fused_adam_fp16. lr, beta1^t and beta2^t are 0-d fp32 tensors
that the kernel reads from device memory, and so is the optional
`do_update` flag (a 0-d bool tensor): where it is False nothing is
written, which is the JAX train step's `_tree_where(do_update, new, old)`
(paddle_tpu/parallel/api.py:590) decided on the device, with no host
sync. A None flag updates unconditionally.

`fused_adam` launches the kernel for CUDA tensors and runs `adam_math`, the
plain version, for CPU tensors; nothing else decides. The JAX package's
FLAGS_use_fused_adam (off by default after a v5e measurement) and its TPU
layout rules (n >= 1024, (rows, 128) tiles, an XLA tail epilogue) are not
carried over: on CUDA every Adam update goes through the kernel, at any n.
"""
from __future__ import annotations

import torch
from torch.autograd.graph import increment_version

from . import _kernels


def adam_math(p32, g, m1, m2, lr, b1p, b2p, wd, *, b1, b2, eps, decoupled):
    """The JAX package's `_adam_math` in the same op order. lr, b1p, b2p
    and wd are fp32 scalars (0-d tensors or Python floats); p32, m1 and m2
    fp32 tensors, g of any float dtype. Returns (new p32, new m1, new m2),
    all fp32."""
    g = g.float()
    if not decoupled:
        g = g + wd * p32
    m1n = b1 * m1 + (1.0 - b1) * g
    m2n = b2 * m2 + (1.0 - b2) * g * g
    update = (m1n / (1.0 - b1p)) / (
        (m2n / (1.0 - b2p)).sqrt() + eps)
    if decoupled:
        update = update + wd * p32
    return p32 - lr * update, m1n, m2n


def fused_adam_plain(p, g, m1, m2, lr, b1p, b2p, wd, *, beta1, beta2,
                     epsilon, decoupled, master=None, do_update=None):
    """`adam_math` applied in place, as the kernel applies it: the moments
    and the master are read widened to fp32 and the results written back
    rounded to each tensor's dtype; where `do_update` (a 0-d bool tensor)
    is False each tensor keeps its old value. Returns (p, m1, m2)."""
    src = p if master is None else master
    new_p, m1n, m2n = adam_math(src.float(), g, m1.float(), m2.float(), lr,
                                b1p, b2p, wd, b1=beta1, b2=beta2,
                                eps=epsilon, decoupled=decoupled)
    for dst, new in ((master, new_p), (p, new_p), (m1, m1n), (m2, m2n)):
        if dst is None:
            continue
        if do_update is not None:
            new = torch.where(do_update, new.to(dst.dtype), dst)
        dst.copy_(new)
    return p, m1, m2


def fused_adam_cuda(p, g, m1, m2, lr, b1p, b2p, wd, *, beta1, beta2,
                    epsilon, decoupled, master=None, do_update=None):
    """Launch the kernel: p, g, m1, m2 (and master) contiguous CUDA tensors
    of one shape; p, g and the moments each float32, bfloat16 or float16
    (m1 and m2 one dtype); master float32 beside a bfloat16 or float16 p;
    lr, b1p, b2p 0-d float32 tensors on the same device; wd a Python
    float; do_update None or a one-element bool tensor on that device
    (False: the kernel writes nothing). Updates in place; returns (p, m1,
    m2)."""
    tensors = [p, g, m1, m2] + ([] if master is None else [master])
    scalars = (lr, b1p, b2p)
    if not all(torch.is_tensor(s) for s in scalars):
        raise TypeError("fused_adam_cuda reads lr, beta1_pow and beta2_pow "
                        "from device memory: pass 0-d float32 tensors")
    if not all(t.is_cuda for t in tensors + list(scalars)):
        raise ValueError("fused_adam_cuda takes CUDA tensors")
    if len({t.device for t in tensors + list(scalars)}) != 1:
        raise ValueError("fused_adam_cuda's tensors must be on one device")
    if any(t.shape != p.shape for t in tensors):
        raise ValueError("p, g, m1, m2 and master must share one shape, got "
                         + "/".join(str(tuple(t.shape)) for t in tensors))
    if any(s.dtype != torch.float32 or s.numel() != 1 for s in scalars):
        raise TypeError("lr, beta1_pow and beta2_pow must be one-element "
                        "float32 tensors")
    if do_update is not None and (
            not torch.is_tensor(do_update) or do_update.dtype != torch.bool
            or do_update.numel() != 1 or do_update.device != p.device):
        raise TypeError("do_update must be a one-element bool tensor on "
                        "p's device")
    if m1.dtype != m2.dtype:
        raise TypeError(f"m1 and m2 must share one dtype, got {m1.dtype}/"
                        f"{m2.dtype}")
    codes = [_kernels.dtype_code(t.dtype) for t in (p, g, m1)]
    if master is not None and (master.dtype != torch.float32
                               or p.dtype == torch.float32):
        raise TypeError("a master weight is float32 beside a bfloat16 or "
                        f"float16 parameter, got {master.dtype} beside "
                        f"{p.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_adam kernel takes contiguous tensors")
    n = p.numel()
    if n == 0:
        return p, m1, m2
    lib = _kernels.load_library()
    rc = lib.pdtt_fused_adam(
        p.data_ptr(), g.data_ptr(), m1.data_ptr(), m2.data_ptr(),
        None if master is None else master.data_ptr(), lr.data_ptr(),
        b1p.data_ptr(), b2p.data_ptr(),
        None if do_update is None else do_update.data_ptr(), n, beta1,
        1.0 - beta1, beta2,
        1.0 - beta2, epsilon, float(wd), int(bool(decoupled)), *codes,
        _kernels.current_stream_handle(p.device))
    name = _kernels.fp16_name("fused_adam", p.dtype, g.dtype, m1.dtype)
    _kernels.check_launch(rc, name)
    _kernels.LAUNCHES[name] += 1
    # written through raw pointers: tell autograd these tensors changed
    for t in tensors:
        increment_version(t)
    return p, m1, m2


def fused_adam(p, g, m1, m2, lr, b1p, b2p, wd, *, beta1, beta2, epsilon,
               decoupled, master=None, do_update=None):
    """Single-pass Adam update of p, m1 and m2 in place (the JAX function's
    arguments; its results are this call's tensors, rounded to their
    dtypes). `master`: the fp32 master weight of a bf16 or fp16 p,
    updated too.
    `do_update`: None, or a 0-d bool tensor that gates the whole update.
    The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = fused_adam_cuda if p.is_cuda else fused_adam_plain
    return fn(p, g, m1, m2, lr, b1p, b2p, wd, beta1=beta1, beta2=beta2,
              epsilon=epsilon, decoupled=decoupled, master=master,
              do_update=do_update)
