"""Optimizers (counterpart of paddle_tpu/optimizer/optimizer.py).

The port keeps the JAX package's compiled train path's semantics
(`apply_gradients_fn`, optimizer.py:220-282): the weight decay, a float
or an `L2Decay`, is applied to every parameter; `multi_precision` keeps
an fp32 master copy of each bf16/fp16 parameter, updates it and writes it
back rounded. Slots live in `state[param]`.

Unlike the JAX package, whose arrays are immutable, `step()` updates
every parameter IN PLACE under `torch.no_grad()` (`p.copy_(new)`), so
the model's own tensors always hold the current weights. The update is
the plain per-parameter math (`ops/fused_adam.adam_math`), about ten
small launches a parameter; the single-pass kernel is the next slice's.

Learning-rate schedulers, per-parameter lr ratios, decay filters and
L1Decay wait for their slice (ROADMAP §1): `learning_rate` is a float
here.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..nn.clip import ClipGradBase
from ..ops.fused_adam import adam_math
from ..regularizer import L2Decay

_LATER = "waits for the optimizer slice (ROADMAP §1: LR schedulers)"


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip: Optional[ClipGradBase] = None,
                 name=None, multi_precision=False):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                f"learning_rate of type {type(learning_rate).__name__} "
                f"{_LATER}; pass a float")
        self._learning_rate = float(learning_rate)
        self._parameter_list: List[torch.Tensor] = (
            list(parameters) if parameters is not None else [])
        self._grad_clip = grad_clip
        self._weight_decay = weight_decay or 0.0
        self._multi_precision = multi_precision
        self.state: Dict[torch.Tensor, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    # ---- lr ----
    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    # ---- the update rule: override in subclasses ----
    def _init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _rule(self, g, p, slots, lr, wd):
        """(new p, new slots) from gradient g and parameter p; pure."""
        raise NotImplementedError

    def _init_slots_mp(self, p):
        slots = self._init_slots(p)
        if self._multi_precision and p.dtype in (torch.bfloat16,
                                                 torch.float16):
            slots["master_weight"] = p.detach().float().clone()
        return slots

    def _rule_mp(self, g, p, slots, lr, wd):
        master = slots.pop("master_weight", None)
        if master is None:
            return self._rule(g, p, slots, lr, wd)
        new_master, new_slots = self._rule(g, master, slots, lr, wd)
        new_slots["master_weight"] = new_master
        return new_master.to(p.dtype), new_slots

    def _leaf_wd(self) -> float:
        wd = self._weight_decay
        return wd.coeff if isinstance(wd, L2Decay) else float(wd)

    # ---- the step ----
    @torch.no_grad()
    def apply_gradients(self, params_grads, lr=None):
        """Clip, then update each (param, grad) pair in place; a None grad
        leaves its param alone. `lr` defaults to get_lr()."""
        lr = self.get_lr() if lr is None else float(lr)
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._step_count += 1
        wd = self._leaf_wd()
        for p, g in params_grads:
            if g is None:
                continue
            slots = self.state.get(p)
            if slots is None:
                slots = self._init_slots_mp(p)
            new_p, self.state[p] = self._rule_mp(g, p, dict(slots), lr, wd)
            p.copy_(new_p)

    def step(self):
        """One update of every parameter that has a gradient."""
        self.apply_gradients([(p, p.grad) for p in self._parameter_list
                              if p.grad is not None])

    def clear_grad(self, set_to_zero=True):
        """Zero every gradient, or drop it (`set_to_zero=False`)."""
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def state_dict(self):
        """{"_step_count": n, "<i>__<slot>": tensor} with i the parameter's
        index in `parameters`, as the JAX package keys unnamed params."""
        out = {"_step_count": self._step_count}
        for i, p in enumerate(self._parameter_list):
            for sname, t in self.state.get(p, {}).items():
                out[f"{i}__{sname}"] = t
        return out


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, moment_dtype="float32"):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        if lazy_mode:
            raise NotImplementedError(
                "lazy_mode (sparse row updates) waits for the sparse slice")
        from ..core.dtype import convert_dtype
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        # bf16 moments halve optimizer-state memory; the math stays fp32
        self._moment_dtype = convert_dtype(moment_dtype)

    def _init_slots(self, p):
        z = dict(device=p.device, dtype=self._moment_dtype)
        one = dict(device=p.device, dtype=torch.float32)
        return {"moment1": torch.zeros(p.shape, **z),
                "moment2": torch.zeros(p.shape, **z),
                "beta1_pow": torch.ones((), **one),
                "beta2_pow": torch.ones((), **one)}

    def _decoupled(self):
        return False

    def _rule(self, g, p, slots, lr, wd):
        b1, b2 = self._beta1, self._beta2
        b1p = slots["beta1_pow"] * b1
        b2p = slots["beta2_pow"] * b2
        new_p32, m1, m2 = adam_math(
            p.float(), g, slots["moment1"].float(), slots["moment2"].float(),
            lr, b1p, b2p, wd or 0.0, b1=b1, b2=b2, eps=self._epsilon,
            decoupled=self._decoupled())
        md = self._moment_dtype
        return new_p32.to(p.dtype), {"moment1": m1.to(md),
                                     "moment2": m2.to(md),
                                     "beta1_pow": b1p, "beta2_pow": b2p}


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01), applied to every
    parameter."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 lr_ratio=None, moment_dtype="float32"):
        if apply_decay_param_fun is not None or lr_ratio is not None:
            raise NotImplementedError(
                f"apply_decay_param_fun / lr_ratio {_LATER}")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name, moment_dtype)

    def _decoupled(self):
        return True
