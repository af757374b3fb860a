"""Move weights between the JAX package and the port, as numpy.

`load_jax_state(model, params)` copies the arrays of a JAX model's
`functional_state()[0]` — handed over as numpy, so this module needs no
JAX — into the port model's parameters of the same names. The map is the
identity: the port keeps the JAX package's parameter names and layouts
(Paddle's `[in, out]` Linear weights included). Each array is cast to the
parameter's dtype and device. `buffers=` (the JAX model's
`functional_state()[1]`: BatchNorm's `_mean` and `_variance`) crosses
into the port model's buffers of the same names the same way.
`export_state(model)` and `export_buffers(model)` go the other way, so
tests can compare parameters and running statistics after training
steps.
`load_jax_optimizer_state(optimizer, model, state)` carries the slots of
a JAX optimizer's `init_state`/`apply_gradients_fn` state (moment1,
moment2, beta1_pow, beta2_pow, master_weight), keyed by the same names,
into the port optimizer's `state`, so both sides can start from the same
non-zero moments; any optimizer's slots cross, since each is keyed by the
names `_init_slots_mp` gives it (SGD none, Momentum and LarsMomentum
`velocity`, Lamb's moments and beta powers, Dpsgd's int32 `noise_salt`
and `noise_step`), each in the dtype the port gives it. MoE's expert
stacks (`w1 [E, H, F]`, `b1`, `w2`, `b2`) and the gate cross like any
other parameter: same names, same layout.
`export_optimizer_state(optimizer, model)` goes the other way: the port
optimizer's slots (master weights of fp16 or bf16 parameters among them)
as numpy, keyed by name and slot.
`shard_state(arrays, model, hcg)` turns a full `{name: array}` (a JAX
tree, or the port's own `export_state` of a degree-1 model) into this
rank's shards for a model built under the hybrid group `hcg`: each
parameter sliced by its `partition_spec` (the model axis), and with
`zero_stage=3` also by its ZeRO spec over sharding (`min_numel` as the
step takes it), the slices the JAX mesh gives this rank's position; other
keys stay whole. `load_jax_state(model, shard_state(...))` then loads the
logical model into the rank, so one seed makes one model at every degree.
`load_jax_step_extras(step, extras)` carries a JAX train step's extras
(the loss scale and its good/bad counters, the gradient-merge accumulator
and its count) into a port step built from the same plan.

A model with frozen parameters (a LoRA-injected one, `tuning.inject_lora`:
every base weight frozen and re-homed under `<site>.base.`, the adapter
leaves `<site>.lora_A` / `lora_B` trainable) crosses as the JAX
`functional_state()` splits it: the trainable parameters in `params`,
the frozen ones in `buffers` beside the real buffers. `load_jax_state`
takes a frozen parameter from either tree, and `export_functional_state`
gives the port model's two trees in that split. Adapter trees
(`tuning.adapter_state_dict`) are host numpy in both packages and cross
as they are.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _check(named, arrays, what):
    """Raise KeyError on a key of `arrays` missing from `named` or extra
    to it, and ValueError on a shape mismatch, naming every offending
    key."""
    missing = sorted(set(named) - set(arrays))
    extra = sorted(set(arrays) - set(named))
    if missing or extra:
        raise KeyError(f"JAX {what} does not match the port model: missing "
                       f"{missing}, extra {extra}")
    bad = [f"{k}: jax {tuple(np.shape(arrays[k]))} vs port "
           f"{tuple(t.shape)}" for k, t in named.items()
           if tuple(np.shape(arrays[k])) != tuple(t.shape)]
    if bad:
        raise ValueError("shape mismatch: " + "; ".join(bad))


def _copy_in(named, arrays):
    """Copy each array into the tensor of its name, cast to that tensor's
    dtype and device."""
    with torch.no_grad():
        for k, t in named.items():
            arr = np.array(arrays[k], dtype=np.float32)  # owned copy
            t.copy_(torch.from_numpy(arr).to(device=t.device, dtype=t.dtype))


def load_jax_state(model: torch.nn.Module,
                   params: Mapping[str, np.ndarray],
                   buffers: Optional[Mapping[str, np.ndarray]] = None
                   ) -> torch.nn.Module:
    """Copy `params` (and `buffers`, where given) into `model` in place
    and return it. Raises KeyError on a missing or extra key and
    ValueError on a shape mismatch, naming every offending key; nothing
    is copied then."""
    named = dict(model.named_parameters())
    # frozen parameters the params tree lacks ride the buffers tree, as
    # the JAX functional_state() puts them there
    frozen = {k: t for k, t in named.items()
              if not t.requires_grad and k not in params}
    named = {k: t for k, t in named.items() if k not in frozen}
    _check(named, params, "state")
    named_b = dict(model.named_buffers())
    if buffers is not None or frozen:
        named_b.update(frozen)
        _check(named_b, buffers or {}, "buffers")
        _copy_in(named_b, buffers)
    _copy_in(named, params)
    return model


def export_functional_state(model: torch.nn.Module):
    """(params, buffers) as the JAX `functional_state()` splits them: the
    parameters that require a gradient, then the frozen parameters and
    the buffers, each {name: float32 numpy copy}."""
    params, rest = {}, export_buffers(model)
    for k, p in model.named_parameters():
        arr = p.detach().float().cpu().numpy().copy()
        (params if p.requires_grad else rest)[k] = arr
    return params, rest


def export_buffers(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """{name: float32 numpy copy} of every buffer (bf16 widened)."""
    return {k: b.detach().float().cpu().numpy().copy()
            for k, b in model.named_buffers()}


def export_state(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """{name: float32 numpy copy} of every parameter (bf16 widened)."""
    return {k: p.detach().float().cpu().numpy().copy()
            for k, p in model.named_parameters()}


def load_jax_optimizer_state(optimizer, model: torch.nn.Module,
                             state: Mapping[str, Mapping[str, np.ndarray]]):
    """Set `optimizer.state[p]` for every named parameter of `model` from
    `state[name][slot]` (numpy, any float dtype). Each slot takes the dtype,
    shape and device the optimizer itself would give it (`_init_slots_mp`;
    Dpsgd's int32 slots stay int32). Raises KeyError on a missing or extra
    name or slot and ValueError on a shape mismatch, naming every
    offending key; nothing is set then."""
    named = dict(model.named_parameters())
    missing = sorted(set(named) - set(state))
    extra = sorted(set(state) - set(named))
    if missing or extra:
        raise KeyError(f"JAX optimizer state does not match the port model: "
                       f"missing {missing}, extra {extra}")
    made = {k: optimizer._init_slots_mp(p) for k, p in named.items()}
    bad_slots = [f"{k}: JAX slots {sorted(state[k])}, port slots "
                 f"{sorted(slots)}" for k, slots in made.items()
                 if set(slots) != set(state[k])]
    if bad_slots:
        raise KeyError("; ".join(bad_slots))
    bad = [f"{k}.{s}: jax {tuple(np.shape(state[k][s]))} vs port "
           f"{tuple(t.shape)}" for k, slots in made.items()
           for s, t in slots.items()
           if tuple(np.shape(state[k][s])) != tuple(t.shape)]
    if bad:
        raise ValueError("shape mismatch: " + "; ".join(bad))
    with torch.no_grad():
        for k, p in named.items():
            for sname, t in made[k].items():
                arr = np.array(state[k][sname],
                               dtype=np.float32 if t.is_floating_point()
                               else np.int64)      # an owned copy
                t.copy_(torch.from_numpy(arr))
            optimizer.state[p] = made[k]
    return optimizer


def export_optimizer_state(optimizer, model: torch.nn.Module
                           ) -> Dict[str, Dict[str, np.ndarray]]:
    """{name: {slot: numpy copy}} of `optimizer.state` for every named
    parameter of `model` that has slots, keyed as the JAX optimizer state
    is (the inverse of load_jax_optimizer_state): floating slots widened
    to float32 (a bf16 or fp16 moment exactly), integer slots as int64."""
    out = {}
    for k, p in model.named_parameters():
        for sname, t in optimizer.state.get(p, {}).items():
            t = t.detach().cpu()
            out.setdefault(k, {})[sname] = (
                t.float().numpy().copy() if t.is_floating_point()
                else t.numpy().astype(np.int64))
    return out


_SCALAR_EXTRAS = {"loss_scale": torch.float32, "good_steps": torch.int32,
                  "bad_steps": torch.int32, "accum_n": torch.int32}


def load_jax_step_extras(step, extras: Mapping[str, object]):
    """Set the port train step's extras from a JAX step's `_extras` (numpy
    or arrays; `accum` a {name: array} dict). The port step must have been
    built from the same plan: each key must already be there. Returns the
    step."""
    mine = step._extras
    missing = sorted(set(extras) - set(mine))
    if missing:
        raise KeyError(f"the port step has no extras {missing}: build it "
                       "from the same plan")
    with torch.no_grad():
        for k, v in extras.items():
            if k == "accum":
                for name, arr in v.items():
                    t = mine["accum"][name]
                    t.copy_(torch.from_numpy(np.array(arr, np.float32)).to(
                        device=t.device, dtype=t.dtype))
            else:
                mine[k] = torch.tensor(np.asarray(v).item(),
                                       dtype=_SCALAR_EXTRAS[k],
                                       device=step.device)
    return step



def shard_state(arrays: Mapping[str, np.ndarray], model: torch.nn.Module,
                hcg, zero_stage: int = 0, min_numel: int = 1024
                ) -> Dict[str, np.ndarray]:
    """This rank's block of every array of the full state `arrays` (numpy,
    read-only views are fine: only the block is copied), by the model's
    partition specs over `hcg`'s layout (module docstring)."""
    from .parallel.hybrid import _param_spec, _zero_spec, shard_of
    mesh = hcg.build_mesh()
    named = dict(model.named_parameters())
    out = {}
    for k, arr in arrays.items():
        p = named.get(k)
        spec = () if p is None else _param_spec(p, mesh)
        if p is not None and zero_stage >= 3:
            spec = _zero_spec(spec, np.shape(arr), mesh,
                              min_numel=min_numel)
        out[k] = np.array(shard_of(np.asarray(arr), spec, mesh))
    return out
