"""Optimizers (counterpart of paddle_tpu/optimizer/optimizer.py).

The port keeps the JAX package's compiled train path's semantics
(`apply_gradients_fn`, optimizer.py:220-282): clip, then per leaf fold an
L1Decay into the gradient (`_reg_grad`), then update with the leaf's
learning rate and weight decay. AdamW's `apply_decay_param_fun(name)` and
`lr_ratio(proxy with .name)` see the parameter's structured name
(`gpt.layers.0.norm1.weight`), which the train steps pass beside the
pairs, as the JAX compiled path sees its name-keyed params dict.
`multi_precision` keeps an fp32 master copy of each bf16/fp16 parameter.
Slots live in `state[param]`. `learning_rate` is a float or an
`LRScheduler` (`optimizer/lr.py`).

Unlike the JAX package, whose arrays are immutable, an update happens IN
PLACE under `torch.no_grad()`: the fused-Adam kernel (CUDA tensors) or
its plain version (CPU tensors) writes the parameter, its moments and its
master weight where they lie, so the model's own tensors always hold the
current weights and `state[param]` keeps pointing at the live moments.
`apply_gradients(..., do_update=flag)` gates a whole update by a 0-d bool
tensor on the device (the JAX step's `_tree_where(do_update, new, old)`):
where it is False every parameter and slot keeps its bits, with no host
sync. SGD, Momentum, LarsMomentum and Lamb (the strategy's LARS and LAMB
swaps) are plain PyTorch, as the JAX package has no kernel for them: each
`_rule` is the JAX `_rule` in its op order.
"""
from __future__ import annotations

import types
from typing import Dict, List, Optional

import torch

from ..nn.clip import ClipGradBase
from ..ops.fused_adam import fused_adam
from ..regularizer import L1Decay, L2Decay, WeightDecayRegularizer
from .lr import LRScheduler


def _commit(dst, new, do_update=None):
    """dst := new in place, or where(do_update, new, dst) with a 0-d
    bool tensor: a skipped update leaves dst's bits as they were."""
    if do_update is not None:
        new = torch.where(do_update, new.to(dst.dtype), dst)
    dst.copy_(new)


def _norm(x):
    """The L2 norm of a whole fp32 tensor (the JAX `_dist_norm` on one
    device, with no stacked layer dims)."""
    return x.square().sum().sqrt()


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip: Optional[ClipGradBase] = None,
                 name=None, multi_precision=False):
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError(f"learning_rate must be a float or an "
                            f"LRScheduler, got {type(learning_rate).__name__}")
        self._learning_rate = learning_rate
        self._parameter_list: List[torch.Tensor] = (
            list(parameters) if parameters is not None else [])
        self._grad_clip = grad_clip
        self._weight_decay = weight_decay or 0.0
        self._multi_precision = multi_precision
        self.state: Dict[torch.Tensor, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    # ---- lr ----
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = value

    @property
    def _lr_scheduler(self):
        return (self._learning_rate
                if isinstance(self._learning_rate, LRScheduler) else None)

    # ---- the update rule: override in subclasses ----
    def _init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _update(self, p, g, slots, lr, wd, do_update=None):
        """Update p and its slots in place from gradient g; lr is a 0-d
        fp32 tensor on p's device, wd a float, do_update None or a 0-d bool
        tensor (False: nothing changes). The default runs `_rule`, the JAX
        optimizer's functional rule, on the master weight where there is
        one (`multi_precision`), and commits its results."""
        master = slots.get("master_weight")
        rule_slots = {k: v for k, v in slots.items() if k != "master_weight"}
        new_p, new_slots = self._rule(g, p if master is None else master,
                                      rule_slots, lr, wd)
        for k, v in new_slots.items():
            _commit(slots[k], v, do_update)
        if master is not None:
            _commit(master, new_p, do_update)
        _commit(p, new_p.to(p.dtype), do_update)

    def _rule(self, g, p, slots, lr, wd):
        """(new p in p's dtype, {slot: new value}) without side effects."""
        raise NotImplementedError

    def _init_slots_mp(self, p):
        slots = self._init_slots(p)
        if self._multi_precision and p.dtype in (torch.bfloat16,
                                                 torch.float16):
            slots["master_weight"] = p.detach().float().clone()
        return slots

    # ---- per-leaf rules of the compiled path ----
    def _base_wd(self) -> float:
        wd = self._weight_decay
        if isinstance(wd, L2Decay):
            return wd.coeff
        if isinstance(wd, WeightDecayRegularizer) or callable(wd):
            return 0.0      # L1 is folded into the gradient by _reg_grad
        return float(wd)

    def _leaf_wd(self, name, wd):
        return wd

    def _leaf_lr(self, name, lr):
        return lr

    def _reg_grad(self, g, p):
        if isinstance(self._weight_decay, L1Decay):
            return g + self._weight_decay.coeff * torch.sign(p.to(g.dtype))
        return g

    # ---- the step ----
    @torch.no_grad()
    def apply_gradients(self, params_grads, lr=None, names=None,
                        do_update=None):
        """Clip, then update each (param, grad) pair in place; a None grad
        leaves its param alone. `lr`: a float or a 0-d fp32 tensor,
        default get_lr(). `names`: each pair's structured parameter name,
        which a decay filter or lr_ratio needs. `do_update`: None or a 0-d
        bool tensor on the parameters' device; where it is False no
        parameter or slot changes (the clip still runs, as in the JAX
        step, whose update is computed and then discarded)."""
        params_grads = list(params_grads)
        if names is not None and len(names) != len(params_grads):
            raise ValueError(f"{len(names)} names for {len(params_grads)} "
                             "parameters")
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._step_count += 1
        if lr is None:
            lr = self.get_lr()
        wd = self._base_wd()
        lr_on = {}          # the lr staged once on each device
        for i, (p, g) in enumerate(params_grads):
            if g is None:
                continue
            lr_t = lr_on.get(p.device)
            if lr_t is None:
                lr_t = lr_on[p.device] = (
                    lr.to(device=p.device, dtype=torch.float32)
                    if torch.is_tensor(lr) else
                    torch.tensor(float(lr), dtype=torch.float32,
                                 device=p.device))
            name = None if names is None else names[i]
            slots = self.state.get(p)
            if slots is None:
                slots = self.state[p] = self._init_slots_mp(p)
            self._update(p, self._reg_grad(g, p), slots,
                         self._leaf_lr(name, lr_t), self._leaf_wd(name, wd),
                         do_update)

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

    # ---- checkpointing ----
    def state_dict(self):
        """{"_step_count": n, "<i>__<slot>": tensor, "LR_Scheduler": {...}}
        with i the parameter's index in `parameters`, as the JAX package
        keys unnamed params; the scheduler's entry only with one."""
        out = {"_step_count": self._step_count}
        for i, p in enumerate(self._parameter_list):
            for sname, t in self.state.get(p, {}).items():
                out[f"{i}__{sname}"] = t
        if self._lr_scheduler is not None:
            out["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return out

    def set_state_dict(self, state):
        """Load what state_dict() wrote: slots are copied onto each
        parameter's device, keeping their dtypes."""
        self._step_count = int(state.get("_step_count", 0))
        if "LR_Scheduler" in state and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(state["LR_Scheduler"])
        for i, p in enumerate(self._parameter_list):
            prefix = f"{i}__"
            slots = {k[len(prefix):]: torch.as_tensor(v).to(p.device).clone()
                     for k, v in state.items()
                     if isinstance(k, str) and k.startswith(prefix)}
            if slots:
                self.state[p] = slots

    set_dict = set_state_dict


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

    def _update(self, p, g, slots, lr, wd, do_update=None):
        # beta^t advanced by one tiny op each before the launch: the kernel
        # reads them, and a block writing them back would race the others;
        # a skipped update (do_update False) keeps them, on the device
        for key, beta in (("beta1_pow", self._beta1),
                          ("beta2_pow", self._beta2)):
            if do_update is None:
                slots[key].mul_(beta)
            else:
                _commit(slots[key], slots[key] * beta, do_update)
        fused_adam(p, g, slots["moment1"], slots["moment2"], lr,
                   slots["beta1_pow"], slots["beta2_pow"], wd,
                   beta1=self._beta1, beta2=self._beta2,
                   epsilon=self._epsilon, decoupled=self._decoupled(),
                   master=slots.get("master_weight"), do_update=do_update)


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01).
    `apply_decay_param_fun(name) -> bool` picks the parameters that decay;
    `lr_ratio(param) -> float` scales a parameter's lr, called with a
    proxy that carries `.name` (the JAX compiled path's convention)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 lr_ratio=None, moment_dtype="float32"):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name, moment_dtype)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _decoupled(self):
        return True

    def _need_name(self, name, what):
        if name is None:
            raise ValueError(
                f"AdamW's {what} needs each parameter's name: update through "
                "ShardedTrainStep/ScanTrainStep or pass "
                "apply_gradients(..., names=)")

    def _leaf_wd(self, name, wd):
        if self._apply_decay_param_fun is None:
            return wd
        self._need_name(name, "apply_decay_param_fun")
        return wd if self._apply_decay_param_fun(name) else 0.0

    def _leaf_lr(self, name, lr):
        if self._lr_ratio is None:
            return lr
        self._need_name(name, "lr_ratio")
        return lr * float(self._lr_ratio(types.SimpleNamespace(name=name)))


class SGD(Optimizer):
    def _rule(self, g, p, slots, lr, wd):
        g = g.float()
        p32 = p.float()
        if wd:
            g = g + wd * p32
        return (p32 - lr * g).to(p.dtype), slots


class Momentum(Optimizer):
    """v = momentum * v + g; p -= lr * v, or with Nesterov
    p -= lr * (g + momentum * v). The velocity is fp32."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, rescale_grad=1.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov
        self._rescale_grad = float(rescale_grad)

    def _init_slots(self, p):
        return {"velocity": torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)}

    def _rule(self, g, p, slots, lr, wd):
        g = g.float()
        if self._rescale_grad != 1.0:
            g = g * self._rescale_grad
        p32 = p.float()
        if wd:
            g = g + wd * p32
        v = self._momentum * slots["velocity"] + g
        update = g + self._momentum * v if self._nesterov else v
        return (p32 - lr * update).to(p.dtype), {"velocity": v}


class LarsMomentum(Optimizer):
    """LARS: each leaf's lr scaled by lars_coeff * |p| / (|g| + wd |p| +
    epsilon) where both norms are positive. `exclude_from_weight_decay`
    is taken and, as on the JAX package's compiled path, not read."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0, name=None):
        super().__init__(learning_rate, parameters, lars_weight_decay,
                         grad_clip, name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._epsilon = epsilon

    def _init_slots(self, p):
        return {"velocity": torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)}

    def _rule(self, g, p, slots, lr, wd):
        g = g.float()
        p32 = p.float()
        p_norm, g_norm = _norm(p32), _norm(g)
        local_lr = torch.where(
            (p_norm > 0) & (g_norm > 0),
            self._lars_coeff * p_norm / (g_norm + wd * p_norm
                                         + self._epsilon), 1.0)
        v = self._momentum * slots["velocity"] + lr * local_lr * (
            g + wd * p32)
        return (p32 - v).to(p.dtype), {"velocity": v}


class Lamb(Optimizer):
    """LAMB: Adam's moments, the update r = m1^ / (sqrt(m2^) + eps) + wd p
    scaled by the trust ratio |p| / |r| where both are positive.
    `exclude_from_weight_decay_fn(proxy with .name)` drops a leaf's decay,
    called with the leaf's structured name as the JAX compiled path calls
    it."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_slots(self, p):
        z = dict(dtype=torch.float32, device=p.device)
        return {"moment1": torch.zeros(p.shape, **z),
                "moment2": torch.zeros(p.shape, **z),
                "beta1_pow": torch.ones((), **z),
                "beta2_pow": torch.ones((), **z)}

    def _leaf_wd(self, name, wd):
        if self._exclude_fn is None:
            return wd
        if name is None:
            raise ValueError(
                "Lamb's exclude_from_weight_decay_fn needs each parameter's "
                "name: update through ShardedTrainStep/ScanTrainStep or pass "
                "apply_gradients(..., names=)")
        return 0.0 if self._exclude_fn(types.SimpleNamespace(name=name)) \
            else wd

    def _rule(self, g, p, slots, lr, wd):
        g = g.float()
        p32 = p.float()
        b1, b2 = self._beta1, self._beta2
        b1p = slots["beta1_pow"] * b1
        b2p = slots["beta2_pow"] * b2
        m1 = b1 * slots["moment1"] + (1 - b1) * g
        m2 = b2 * slots["moment2"] + (1 - b2) * g * g
        m1h = m1 / (1 - b1p)
        m2h = m2 / (1 - b2p)
        r = m1h / (m2h.sqrt() + self._epsilon) + wd * p32
        w_norm, r_norm = _norm(p32), _norm(r)
        trust = torch.where(w_norm > 0, torch.where(r_norm > 0,
                                                    w_norm / r_norm, 1.0),
                            1.0)
        new_p = (p32 - lr * trust * r).to(p.dtype)
        return new_p, {"moment1": m1, "moment2": m2, "beta1_pow": b1p,
                       "beta2_pow": b2p}
