"""Autocast state and input casting (counterpart of paddle_tpu/core/amp.py).

The JAX package decides each op's dtype where the op is traced:
`autocast_inputs(op_name, *arrays)` casts a white-listed op's fp32 inputs
to the autocast dtype (bf16 or fp16), a black-listed op's bf16/fp16
inputs to fp32, and leaves a gray op's inputs alone. The port makes the
same decision at the same op boundaries, eagerly: `nn.functional.linear`
(so `Linear` and the tensor-parallel linears), `tensor.linalg.matmul`,
`nn.functional.softmax` and `log_softmax` call it. `torch.autocast` is not
used: its CUDA and CPU op lists differ from each other and from these, so
the card and the CPU would run different programs. The cast is a plain
`.to()`, so autograd carries each gradient back in its input's dtype.

The state is thread-local, as in the JAX package. `amp_snapshot()` and
`amp_restored(snapshot)` carry it into a recomputed forward
(distributed/fleet/utils/recompute.py), which runs during the backward,
outside the `auto_cast` block that ran the first forward.
"""
from __future__ import annotations

import contextlib
import threading

import torch

# The reference's AmpOperators defaults, as the JAX package lists them:
# white = matrix-product ops, black = numerically sensitive ops.
WHITE_LIST = frozenset({
    "matmul", "mul", "conv1d", "conv2d", "conv3d", "conv_transpose",
    "linear", "bmm", "einsum", "addmm",
})
BLACK_LIST = frozenset({
    "softmax", "log_softmax", "softmax_with_cross_entropy", "cross_entropy",
    "layer_norm", "batch_norm", "instance_norm", "group_norm",
    "exp", "log", "mean", "sum", "square", "reduce_sum", "cos_sim",
    "sigmoid_cross_entropy_with_logits", "nll_loss", "erf", "pow",
})

_LOW = (torch.bfloat16, torch.float16)


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = frozenset()
        self.custom_black = frozenset()


_AMP = _AmpState()


def amp_state():
    return _AMP


def amp_enabled() -> bool:
    return _AMP.enabled


def amp_snapshot():
    """The whole autocast state of this thread, as a tuple."""
    st = _AMP
    return (st.enabled, st.dtype, st.level, st.custom_white, st.custom_black)


def _set(snapshot):
    st = _AMP
    (st.enabled, st.dtype, st.level, st.custom_white,
     st.custom_black) = snapshot


@contextlib.contextmanager
def amp_restored(snapshot):
    """Run the block under `snapshot` (from amp_snapshot()), then put back
    the state that was there."""
    prev = amp_snapshot()
    _set(snapshot)
    try:
        yield
    finally:
        _set(prev)


def autocast_inputs(op_name: str, *tensors):
    """Cast an op's tensor inputs by the active autocast lists.

    White-listed op: float32 inputs -> the autocast dtype (bf16/fp16).
    Black-listed op: bf16/fp16 inputs -> float32.
    Unlisted (gray) op: inputs as they are; PyTorch's type promotion
    takes it from there, as jnp's does in the JAX package.

    Returns a tuple of the same length; None and non-tensors pass
    through. A custom list entry overrides the defaults, as in the JAX
    package."""
    st = _AMP
    if not st.enabled or st.level not in ("O1", "O2"):
        return tensors
    in_white = (op_name in st.custom_white
                or (op_name in WHITE_LIST and op_name not in st.custom_black))
    in_black = (op_name in st.custom_black
                or (op_name in BLACK_LIST and op_name not in st.custom_white))
    if in_white:
        return tuple(t.to(st.dtype) if torch.is_tensor(t)
                     and t.dtype == torch.float32 else t for t in tensors)
    if in_black:
        return tuple(t.float() if torch.is_tensor(t) and t.dtype in _LOW
                     else t for t in tensors)
    return tensors
