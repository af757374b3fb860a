"""Optimizers (counterpart of paddle_tpu/optimizer/optimizer.py).

The port keeps the JAX package's compiled train path's semantics
(`apply_gradients_fn`, optimizer.py:220-282): clip, then per leaf fold an
L1Decay into the gradient (`_reg_grad`), then update with the leaf's
learning rate and weight decay. The eager `step()` is the JAX eager step
(optimizer.py:107-165): it also reads each parameter's
`optimize_attr["learning_rate"]` (`ParamAttr(learning_rate=)`), which
scales its lr, and `no_weight_decay`, which drops its L2 or decoupled
decay and its L1 term; the compiled path reads neither, as in JAX.
AdamW's `apply_decay_param_fun(name)` and `lr_ratio(proxy with .name)`
see the parameter's structured name (`gpt.layers.0.norm1.weight`), which
the train steps pass beside the pairs, as the JAX compiled path sees its
name-keyed params dict. `multi_precision` keeps an fp32 master copy of
each bf16/fp16 parameter. Slots live in `state[param]`. `learning_rate`
is a float or an `LRScheduler` (`optimizer/lr.py`).

Unlike the JAX package, whose arrays are immutable, an update happens IN
PLACE under `torch.no_grad()`: the fused-Adam kernel (CUDA tensors) or
its plain version (CPU tensors) writes the parameter, its moments and its
master weight where they lie, so the model's own tensors always hold the
current weights and `state[param]` keeps pointing at the live moments.
`apply_gradients(..., do_update=flag)` gates a whole update by a 0-d bool
tensor on the device (the JAX step's `_tree_where(do_update, new, old)`):
where it is False every parameter and slot keeps its bits, with no host
sync. Every optimizer but Adam and AdamW is plain PyTorch, as the JAX
package has no kernel for it: each `_rule` is the JAX `_rule` in its op
order, its slots fp32 (Dpsgd's two int32), computed in fp32 and cast back
to the parameter's dtype.
"""
from __future__ import annotations

import types
from typing import Dict, List, Optional

import torch

from ..core import threefry
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

    def _reg_grad(self, g, p, no_decay=False):
        if isinstance(self._weight_decay, L1Decay) and not no_decay:
            return g + self._weight_decay.coeff * torch.sign(p.to(g.dtype))
        return g

    # the eager step honours a parameter's no_weight_decay in its decay
    # (the JAX `_wd_for`); Lamb's eager `_wd_for` does not (JAX)
    _eager_no_decay = True

    # ---- the step ----
    def apply_gradients(self, params_grads, lr=None, names=None,
                        do_update=None):
        """Clip, then update each (param, grad) pair in place; a None grad
        leaves its param alone. `lr`: a float or a 0-d fp32 tensor,
        default get_lr(). `names`: each pair's structured parameter name,
        which a decay filter or lr_ratio needs. `do_update`: None or a 0-d
        bool tensor on the parameters' device; where it is False no
        parameter or slot changes (the clip still runs, as in the JAX
        step, whose update is computed and then discarded). The compiled
        path's update: `optimize_attr` and `no_weight_decay` are not
        read."""
        self._apply(params_grads, lr, names, do_update, eager=False)

    @torch.no_grad()
    def _apply(self, params_grads, lr, names, do_update, eager):
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
        lr_on = {}          # each lr staged once on each device
        for i, (p, g) in enumerate(params_grads):
            if g is None:
                continue
            leaf_lr, no_decay = lr, False
            if eager:
                # the JAX eager step's lr: the Python float get_lr() times
                # the parameter's optimize_attr, rounded to fp32 once
                attr = getattr(p, "optimize_attr", None)
                if attr is not None and attr["learning_rate"] != 1.0:
                    leaf_lr = float(lr) * attr["learning_rate"]
                no_decay = bool(getattr(p, "no_weight_decay", False))
            key = (p.device, None if torch.is_tensor(leaf_lr)
                   else float(leaf_lr))
            lr_t = lr_on.get(key)
            if lr_t is None:
                lr_t = lr_on[key] = (
                    leaf_lr.to(device=p.device, dtype=torch.float32)
                    if torch.is_tensor(leaf_lr) else
                    torch.tensor(float(leaf_lr), dtype=torch.float32,
                                 device=p.device))
            name = None if names is None else names[i]
            self.init_slots([p])
            leaf_wd = self._leaf_wd(name, wd)
            if no_decay and self._eager_no_decay:
                leaf_wd = 0.0
            self._update(p, self._reg_grad(g, p, no_decay), self.state[p],
                         self._leaf_lr(name, lr_t), leaf_wd, do_update)

    def init_slots(self, params):
        """Create the slots of every parameter of `params` that has none,
        in that order (the JAX `init_state` walks the model's parameters
        in order; Dpsgd's noise streams are numbered so)."""
        for p in params:
            if p not in self.state:
                self.state[p] = self._init_slots_mp(p)

    def step(self):
        """One update of every parameter that has a gradient, reading
        each one's `optimize_attr` and `no_weight_decay` (the JAX eager
        step)."""
        self._apply([(p, p.grad) for p in self._parameter_list
                     if p.grad is not None], None, None, None, eager=True)

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
    def _slot_key(self, i, p):
        """A parameter's slot prefix: its `ParamAttr` name, else its index
        in `parameters` (the JAX `p.name or i`, optimizer.py:286-296)."""
        return getattr(p, "attr_name", None) or i

    def state_dict(self):
        """{"_step_count": n, "<key>__<slot>": tensor, "LR_Scheduler":
        {...}} with key the parameter's ParamAttr name, else its index in
        `parameters`, as the JAX package keys them; the scheduler's entry
        only with one."""
        out = {"_step_count": self._step_count}
        for i, p in enumerate(self._parameter_list):
            for sname, t in self.state.get(p, {}).items():
                out[f"{self._slot_key(i, p)}__{sname}"] = t
        if self._lr_scheduler is not None:
            out["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return out

    @torch.no_grad()
    def set_state_dict(self, state):
        """Load what state_dict() wrote (here or in the JAX package): slots
        are copied onto each parameter's device, keeping their dtypes. A
        slot that exists with the same shape and dtype is written in
        place, so its storage stays the one the train step updates (a
        rollback keeps every slot's `data_ptr`)."""
        self._step_count = int(state.get("_step_count", 0))
        if "LR_Scheduler" in state and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(state["LR_Scheduler"])
        for i, p in enumerate(self._parameter_list):
            prefix = f"{self._slot_key(i, p)}__"
            slots = {k[len(prefix):]: torch.as_tensor(v)
                     for k, v in state.items()
                     if isinstance(k, str) and k.startswith(prefix)}
            if not slots:
                continue
            live = self.state.get(p, {})
            new = {}
            for name, v in slots.items():
                cur = live.get(name)
                if cur is not None and cur.shape == v.shape and \
                        cur.dtype == v.dtype:
                    cur.copy_(v)
                    new[name] = cur
                else:
                    new[name] = v.to(p.device).clone()
            self.state[p] = new

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
        g, p32 = _decayed(g, p, wd)
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

    _eager_no_decay = False

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


def _zeros32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _decayed(g, p, wd):
    """(fp32 g with wd * p folded in, fp32 p): the JAX rules' prologue."""
    g = g.float()
    p32 = p.float()
    if wd:
        g = g + wd * p32
    return g, p32


class Adamax(Optimizer):
    """m = b1 m + (1 - b1) g; u = max(b2 u, |g|);
    p -= lr / (1 - b1^t) * m / (u + eps)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_slots(self, p):
        return {"moment": _zeros32(p), "inf_norm": _zeros32(p),
                "beta1_pow": torch.ones((), dtype=torch.float32,
                                        device=p.device)}

    def _rule(self, g, p, slots, lr, wd):
        g, p32 = _decayed(g, p, wd)
        b1p = slots["beta1_pow"] * self._beta1
        m = self._beta1 * slots["moment"] + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * slots["inf_norm"], g.abs())
        new_p = p32 - lr / (1 - b1p) * m / (u + self._epsilon)
        return new_p.to(p.dtype), {"moment": m, "inf_norm": u,
                                   "beta1_pow": b1p}


class Adagrad(Optimizer):
    """acc += g^2; p -= lr g / (sqrt(acc) + eps). The constructor takes
    `name` before `initial_accumulator_value`, as Paddle's does."""

    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_slots(self, p):
        return {"moment": torch.full(p.shape, float(self._init_acc),
                                     dtype=torch.float32, device=p.device)}

    def _rule(self, g, p, slots, lr, wd):
        g, p32 = _decayed(g, p, wd)
        acc = slots["moment"] + g * g
        new_p = p32 - lr * g / (acc.sqrt() + self._epsilon)
        return new_p.to(p.dtype), {"moment": acc}


class RMSProp(Optimizer):
    """ms = rho ms + (1 - rho) g^2 (centered: also mg, the denominator
    sqrt(ms - mg^2 + eps)); mom = momentum mom + lr g / denom; p -= mom."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_slots(self, p):
        slots = {"mean_square": _zeros32(p), "momentum": _zeros32(p)}
        if self._centered:
            slots["mean_grad"] = _zeros32(p)
        return slots

    def _rule(self, g, p, slots, lr, wd):
        g, p32 = _decayed(g, p, wd)
        ms = self._rho * slots["mean_square"] + (1 - self._rho) * g * g
        out = {"mean_square": ms}
        if self._centered:
            mg = self._rho * slots["mean_grad"] + (1 - self._rho) * g
            denom = (ms - mg * mg + self._epsilon).sqrt()
            out["mean_grad"] = mg
        else:
            denom = (ms + self._epsilon).sqrt()
        mom = self._momentum * slots["momentum"] + lr * g / denom
        out["momentum"] = mom
        return (p32 - mom).to(p.dtype), out


class Adadelta(Optimizer):
    """asg = rho asg + (1 - rho) g^2; update = sqrt(asu + eps) /
    sqrt(asg + eps) g; asu = rho asu + (1 - rho) update^2;
    p -= lr update."""

    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon, self._rho = epsilon, rho

    def _init_slots(self, p):
        return {"avg_squared_grad": _zeros32(p),
                "avg_squared_update": _zeros32(p)}

    def _rule(self, g, p, slots, lr, wd):
        g, p32 = _decayed(g, p, wd)
        asg = self._rho * slots["avg_squared_grad"] + (1 - self._rho) * g * g
        update = ((slots["avg_squared_update"] + self._epsilon).sqrt()
                  / (asg + self._epsilon).sqrt()) * g
        asu = (self._rho * slots["avg_squared_update"]
               + (1 - self._rho) * update * update)
        return (p32 - lr * update).to(p.dtype), {
            "avg_squared_grad": asg, "avg_squared_update": asu}


class DecayedAdagrad(Optimizer):
    """acc = decay acc + (1 - decay) g^2; p -= lr g / (sqrt(acc) + eps)."""

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-06,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._decay, self._epsilon = decay, epsilon

    def _init_slots(self, p):
        return {"moment": _zeros32(p)}

    def _rule(self, g, p, slots, lr, wd):
        g, p32 = _decayed(g, p, wd)
        acc = self._decay * slots["moment"] + (1.0 - self._decay) * g * g
        new_p = p32 - lr * g / (acc.sqrt() + self._epsilon)
        return new_p.to(p.dtype), {"moment": acc}


class Ftrl(Optimizer):
    """FTRL-proximal: the squared-gradient and linear accumulators, then
    the per-coordinate proximal step with L1 / L2 shrinkage."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _init_slots(self, p):
        return {"squared": _zeros32(p), "linear": _zeros32(p)}

    def _rule(self, g, p, slots, lr, wd):
        g = g.float()
        p32 = p.float()
        sq, lin = slots["squared"], slots["linear"]
        new_sq = sq + g * g
        lp = -self._lr_power
        sigma = (new_sq ** lp - sq ** lp) / lr
        new_lin = lin + g - sigma * p32
        x = self._l1 * torch.sign(new_lin) - new_lin
        y = new_sq ** lp / lr + 2.0 * self._l2
        new_p = torch.where(new_lin.abs() > self._l1, x / y, 0.0)
        return new_p.to(p.dtype), {"squared": new_sq, "linear": new_lin}


class Dpsgd(Optimizer):
    """Differentially private SGD: each leaf's gradient clipped to L2 norm
    `clip`, plus one Gaussian draw a leaf a step scaled by sigma /
    batch_size. The draw is `jax.random.normal` on the key
    fold_in(fold_in(PRNGKey(seed), salt), step) (`core/threefry.py`),
    with the leaf's salt numbered 1, 2, ... in the order its slots are
    made and its step counted in an int32 slot, both on the device."""

    def __init__(self, learning_rate, clip=10.0, batch_size=16.0,
                 sigma=1.0, seed=0, parameters=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._clip, self._bs, self._sigma = clip, batch_size, sigma
        self._seed = seed
        self._salt_counter = 0

    def _init_slots(self, p):
        self._salt_counter += 1
        i32 = dict(dtype=torch.int32, device=p.device)
        return {"noise_salt": torch.tensor(self._salt_counter, **i32),
                "noise_step": torch.zeros((), **i32)}

    def _rule(self, g, p, slots, lr, wd):
        g = g.float()
        p32 = p.float()
        l2 = (g * g).sum().sqrt()
        scale = torch.clamp_min(l2 / self._clip, 1.0)
        key = threefry.fold_in(threefry.fold_in(
            threefry.prng_key(self._seed, device=p.device),
            slots["noise_salt"]), slots["noise_step"])
        noise = threefry.normal(key, ()) * self._sigma
        new_p = p32 - lr * (g / scale + noise / self._bs)
        return new_p.to(p.dtype), {"noise_salt": slots["noise_salt"],
                                   "noise_step": slots["noise_step"] + 1}


class ProximalAdagrad(Optimizer):
    """acc += g^2; an Adagrad step at lr / sqrt(acc), then the L1 / L2
    soft-threshold shrinkage."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, parameters=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._l1, self._l2 = l1, l2

    def _init_slots(self, p):
        return {"moment": _zeros32(p)}

    def _rule(self, g, p, slots, lr, wd):
        g = g.float()
        p32 = p.float()
        acc = slots["moment"] + g * g
        lr_t = lr / acc.sqrt()
        prox = p32 - lr_t * g
        new_p = torch.sign(prox) * torch.clamp_min(
            prox.abs() - lr_t * self._l1, 0.0) / (1.0 + lr_t * self._l2)
        return new_p.to(p.dtype), {"moment": acc}


class ProximalGD(Optimizer):
    """An SGD step, then ProximalAdagrad's shrinkage at lr (no slot)."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, parameters=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._l1, self._l2 = l1, l2

    def _rule(self, g, p, slots, lr, wd):
        g = g.float()
        p32 = p.float()
        prox = p32 - lr * g
        new_p = torch.sign(prox) * torch.clamp_min(
            prox.abs() - lr * self._l1, 0.0) / (1.0 + lr * self._l2)
        return new_p.to(p.dtype), {}
