"""AMP: auto_cast, decorate and GradScaler (counterpart of
paddle_tpu/amp/__init__.py).

`auto_cast` sets the thread-local autocast state of `core/amp.py`, which
the white-, black- and gray-listed ops read as they run. bf16 is the
default dtype; fp16 with dynamic loss scaling (`GradScaler`, or the
strategy step's device-side scaler, parallel/api.py) is kept for parity.

`GradScaler` is the eager scaler and keeps the JAX class's arithmetic:
the scale is a Python float, gradients are unscaled by dividing in fp32,
`(g.float() / scale).to(g.dtype)` (a multiply by 1 / scale, as
`torch.amp.GradScaler` does, differs in the last bit when the scale is not
a power of two), one finite census covers every gradient, and `update()`
moves the scale once an iteration.
"""
from __future__ import annotations

import contextlib

import torch

from ..core.amp import (_AMP, BLACK_LIST, WHITE_LIST,  # noqa: F401
                        amp_enabled, amp_state, autocast_inputs)
from ..core.dtype import convert_dtype


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    prev = (_AMP.enabled, _AMP.dtype, _AMP.level, _AMP.custom_white,
            _AMP.custom_black)
    _AMP.enabled = enable
    _AMP.dtype = convert_dtype(dtype)
    _AMP.level = level
    _AMP.custom_white = frozenset(custom_white_list or ())
    _AMP.custom_black = frozenset(custom_black_list or ())
    try:
        yield
    finally:
        (_AMP.enabled, _AMP.dtype, _AMP.level, _AMP.custom_white,
         _AMP.custom_black) = prev


autocast = auto_cast


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast the models' parameters to the AMP dtype (pure bf16/fp16
    training); O1 leaves them. Returns the models (and the optimizers)."""
    d = convert_dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dtype=d)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


class GradScaler:
    """Dynamic loss scaling, eagerly (the JAX class's defaults: decrease
    by 0.5 after every non-finite step, grow by 2 after 1000 finite ones).
    """

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = set()  # ids of optimizers already unscaled

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        """Divide every gradient of `optimizer`'s parameters by the scale
        in fp32 (back to the gradient's dtype) and record whether any is
        non-finite: one census over all of them, one host sync."""
        if not self._enable or id(optimizer) in self._unscaled:
            return
        self._unscaled.add(id(optimizer))
        from ..obs.numerics import all_finite
        params = [p for p in optimizer._parameter_list if p.grad is not None]
        if not params:
            self._found_inf = False
            return
        unscaled = [p.grad.float() / self._scale for p in params]
        finite = all_finite(unscaled)
        for p, g in zip(params, unscaled):
            p.grad = g.to(p.grad.dtype)
        self._found_inf = not bool(finite)

    def step(self, optimizer):
        """Unscale (if not already) and step, skipping the step when a
        gradient is non-finite. Does not move the scale: call update()
        once an iteration (minimize() does both)."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def update(self):
        self._unscaled.clear()
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)
