"""Train steps on one GPU (counterpart of paddle_tpu/parallel/api.py).

`ShardedTrainStep` runs one step: forward, backward, clip, then update,
in the order of the JAX package's `train_step` (api.py:473-600).
`ScanTrainStep` runs K such steps over stacked `[K, ...]` inputs, with the
JAX runner's per-step learning-rate vector (an attached `LRScheduler` is
advanced once per step, api.py:881-892) and global steps 1..K, and
returns the `[K]` fp32 loss vector, which stays on the device (nothing in
the chunk waits for the host). The lr vector is staged on the device once
a chunk, so each step hands the optimizer a device scalar. The JAX runner
fuses the K steps into one compiled dispatch; here they run eagerly, one
after another, and `dispatch_count` counts chunks. A CUDA graph of the
chunk is later work.

With `plan=` (a `CompiledStrategy`, which `parallelize(model, opt,
strategy=s)` builds from a `DistributedStrategy`) the step also executes,
as the JAX step does on a one-device mesh:
- AMP: the forward under `auto_cast` (bf16 or fp16), and with fp16 and
  `use_dynamic_loss_scaling` the loss scale, its good and bad counters,
  the finite census and the skipped update, all kept and decided on the
  device: nothing in a step waits for the host;
- recompute of the whole loss, or of the sublayers that
  `recompute_configs.checkpoints` names (`apply_selective_remat`);
- gradient merge over `k_steps` (avg or sum), its boundaries on the
  global step index;
- `fp16_allreduce` (fp32 gradients rounded through fp16, as JAX does at
  degree 1); `comm_quant` and the `sum` gradient scale, which at degree 1
  are exact no-ops in JAX too;
- ZeRO: any stage shards nothing on one device; `sharding_configs.offload`
  keeps the optimizer state in host memory (pinned on CUDA) between
  updates and stages it in around each;
- the LARS and LAMB swaps (`plan.optimizer`).
`sync_batch_norm` converts the model's BatchNorms to SyncBatchNorm in
`parallelize`, before the step is built, as the JAX parallelize does; at
one device they are BatchNorm.

Several ranks: one process a rank. After `fleet.init(is_collective=True,
strategy)` (or given `mesh=`, a `HybridMesh` from the hybrid group's
`build_mesh()`) the step runs data, sharding (ZeRO 1-3) and tensor
parallelism over the hybrid group (`parallel/hybrid.py`): each call
takes the global batch and uses this rank's slice, the gradients are
averaged over the batch ranks, a global-norm clip becomes the hybrid
clip (`HybridParallelClipGrad`: squared norms summed over the model and
sharding groups, a replicated leaf counted once, never summed over
data), an fp16 census is agreed over every rank, and `state_dict()`
gathers the full logical state on every rank, as the JAX step's does
(api.py:746-759). AMP, recompute, gradient merge, ScanTrainStep's lr
vector and numerics run per rank as at one device. What stays refused
names its sub-item of ROADMAP §1 item 8: pipeline and `pp_degree` (8b),
`sep` and sequence parallelism (8c), LocalSGD (8d), `ep_degree` (8e),
buffers (BatchNorm statistics) over batch ranks (8f), `comm_quant` over
several batch ranks (8a, with compression and DGC), and LARS and LAMB over
sharded leaves (8g); a list of several devices in one process is refused:
one process a rank. asp and qat raise and name the item that ports their
modules.

A model with buffers (BatchNorm's running statistics) moves them in
place in its forward, once a step, as the JAX step carries them; with
gradient merge every micro-step's forward moves them, and an fp16 step
whose update is skipped keeps what its forward did, both as in JAX.
Whole-loss recompute reruns the forward in the backward without moving
them again (`recompute.replaying()`); selective recompute of a sublayer
that holds buffers is refused, because the JAX step cannot run it (the
running statistics leak a tracer out of its `jax.checkpoint`).

The optimizer gets each leaf's structured name beside its gradient (the
keys of the JAX compiled path's params dict), so AdamW's decay filter and
lr_ratio see `gpt.layers.0.norm1.weight` as they do there.

Numerics (`numerics=True`, or a plan compiled from `strategy.numerics`)
arms the in-step telemetry of obs/numerics.py: per-group gradient norms,
parameter norms and update ratios l2(new - old) / l2(old), as 0-d fp32
tensors in `_extras["numerics"]` under the JAX keys. The JAX step reads
them from its functional old and new parameters; here the optimizer
updates in place, so the armed step reads the gradients (unscaled,
before the merge and the clip, zeroed on a skipped fp16 step, as JAX
reads them) before they are dropped, and keeps a copy of the parameters
it is about to update. A ScanTrainStep computes them on the last step of
each chunk only, the one whose values the JAX chunk leaves in its
carry. `numerics_host_sample()` reads them in one copy, and
`nonfinite_blame(step, *batch)` counts the non-finite elements of every
gradient and parameter on the given batch (the loss differentiated
again with `torch.autograd.grad`, no update): the live gradients,
optimizer state, model buffers and RNG state are as they were, and an
armed step's probe replays the RNG state its `step` started from, so it
sees that step's dropout masks.

The model's parameters are updated in place (see optimizer/optimizer.py);
`state_dict()` is the model's. The gradients are dropped after every
step. The step runs on CUDA unless `device="cpu"` (or a one-device CPU
mesh) is given, and raises without a GPU otherwise.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.random import rng_restore, rng_snapshot
from ..distributed.fleet.utils.recompute import recompute
from ..distributed.topology import HybridMesh, get_mesh
from ..obs.numerics import (all_finite, group_index, in_step_telemetry,
                            nonfinite_count, telemetry_groups, telemetry_keys)
from .hybrid import HybridLayout, _batch_axes, _param_spec, _zero_spec  # noqa: F401

_ONE_PROCESS_A_RANK = ("takes one process a rank: start one process for "
                       "each device (distributed.spawn or a launcher) and "
                       "call fleet.init in each")
_ITEM8 = {"pipeline": "pipeline parallelism waits for ROADMAP §1 item 8b",
          "sep": "sequence parallelism waits for ROADMAP §1 item 8c",
          "localsgd": "waits for ROADMAP §1 item 8d",
          "ep": "expert parallelism waits for ROADMAP §1 item 8e",
          "buffers": "buffers (BatchNorm statistics) across batch ranks "
                     "wait for SyncBatchNorm over ranks, ROADMAP §1 item 8f",
          "comm_quant": "quantized gradient collectives wait for "
                        "compression, ROADMAP §1 item 8a",
          "trust": "takes norms of whole leaves; over sharded leaves it "
                   "waits for ROADMAP §1 item 8g"}
# plan fields whose modules another item ports
_REFUSED = (("asp", "2:4 sparsity (incubate/asp) waits for ROADMAP §1 "
             "item 9"),
            ("qat", "quantization-aware training (quantization/) waits "
             "for ROADMAP §1 item 9"))


def _resolve_mesh(mesh, device) -> torch.device:
    """None, a device, a one-device sequence, or a HybridMesh (this
    rank's device from init_parallel_env) -> torch.device."""
    if isinstance(mesh, HybridMesh):
        if device is not None:
            return resolve_device(device)
        from ..distributed.parallel_env import current_device
        return current_device()
    if isinstance(mesh, (list, tuple)):
        if len(mesh) != 1:
            raise NotImplementedError(
                f"a mesh over {len(mesh)} devices in one process: the port "
                f"{_ONE_PROCESS_A_RANK}")
        mesh = mesh[0]
    if mesh is not None and device is not None and \
            resolve_device(mesh) != resolve_device(device):
        raise ValueError(f"mesh {mesh!r} and device {device!r} disagree")
    return resolve_device(device if device is not None else mesh)


def _refuse(plan, strategy=None):
    """Raise on what a plan asks that the step cannot run."""
    from ..distributed.fleet.strategy_compiler import CompiledStrategy
    if not isinstance(plan, CompiledStrategy):
        raise TypeError(f"plan must be a CompiledStrategy (StrategyCompiler"
                        f"().compile or parallelize), got "
                        f"{type(plan).__name__}")
    if plan.pipeline:
        raise NotImplementedError(f"strategy.pipeline: {_ITEM8['pipeline']}")
    if plan.localsgd_k:
        kind = "adaptive_localsgd" if plan.localsgd_adaptive else "localsgd"
        raise NotImplementedError(f"strategy.{kind}: {_ITEM8['localsgd']}")
    for field, why in _REFUSED:
        if getattr(plan, field):
            raise NotImplementedError(f"strategy.{field}: {why}")
    if strategy is not None:
        hc = strategy.hybrid_configs
        for name, why in (("pp_degree", "pipeline"), ("sep_degree", "sep"),
                          ("ep_degree", "ep")):
            if getattr(hc, name, 1) > 1:
                raise NotImplementedError(
                    f"hybrid_configs.{name}={getattr(hc, name)}: "
                    f"{_ITEM8[why]}")


def _check_group(strategy, mesh):
    """A strategy whose hybrid degrees ask for several ranks needs the
    running hybrid group of those degrees (fleet.init)."""
    hc = strategy.hybrid_configs
    want = {"data": hc.dp_degree, "sharding": hc.sharding_degree,
            "model": hc.mp_degree}
    if all(v in (1, -1, None) for v in want.values()):
        return
    have = mesh.shape if isinstance(mesh, HybridMesh) else None
    if have is None or any(v not in (-1, None) and have.get(a, 1) != v
                           for a, v in want.items()):
        raise RuntimeError(
            f"hybrid_configs {want} need a running hybrid group of those "
            f"degrees (fleet.init(is_collective=True, strategy=...) in "
            f"every rank, one process a rank); the running one is "
            f"{have or 'none'}")


def make_compute_loss(model, loss_fn=None, amp_ctx=None):
    """(*arrays) -> fp32 loss. loss_fn=None means the model returns its own
    scalar loss (causal-LM style: model(input_ids, labels)). `amp_ctx`: a
    context-manager factory the forward runs under (the plan's
    auto_cast)."""
    ctx = amp_ctx or contextlib.nullcontext

    def compute_loss(*arrays):
        with ctx():
            if loss_fn is None:
                loss = model(*arrays)
            else:
                loss = loss_fn(model(arrays[0]), *arrays[1:])
        return loss.float()

    return compute_loss


def apply_selective_remat(model, checkpoints) -> list:
    """Recompute the named sublayers' forwards in the backward (selective
    recompute, recompute_configs.checkpoints): a sublayer whose name is an
    entry, or lies under one, is wrapped; only the topmost match, so
    nothing is recomputed twice. Returns the wrapped names; empty means
    nothing matched. Raises, wrapping nothing, where a matched sublayer
    holds buffers (module docstring)."""
    matched = []
    for name, sub in model.named_modules():
        if not name or not any(name == c or name.startswith(c + ".")
                               for c in checkpoints):
            continue
        if any(name.startswith(w + ".") for w, _ in matched):
            continue  # an ancestor is already matched
        matched.append((name, sub))
    held = [f"{n}.{b}" for n, sub in matched
            for b, _ in sub.named_buffers()]
    if held:
        raise NotImplementedError(
            f"selective recompute of sublayers holding buffers "
            f"({held[:3]}...): the JAX step cannot trace it (the running "
            "statistics leak out of its jax.checkpoint); recompute the "
            "whole loss instead (no recompute_configs.checkpoints)")
    for _, sub in matched:
        _wrap_forward_remat(sub)
    return [n for n, _ in matched]


def _wrap_forward_remat(layer):
    """layer.forward := its recomputed form (non-reentrant, so parameters
    reached through the layer get gradients whatever its inputs), under
    the autocast state of each call."""
    orig = layer.forward
    if getattr(orig, "_is_remat_wrapped", False):
        return

    def forward(*args, **kwargs):
        return recompute(orig, *args, use_reentrant=False, **kwargs)

    forward._is_remat_wrapped = True
    layer.forward = forward


class ShardedTrainStep:
    """One train step (forward, backward, clip, update) on one device.

    usage:
        step = ShardedTrainStep(model, optimizer)   # CUDA by default
        loss = step(input_ids, labels)              # 0-d fp32 on the device

    With `plan=` it executes the strategy's AMP, loss scaling, recompute,
    gradient merge, offload and optimizer swap; `numerics=True` (or the
    plan's) arms the in-step telemetry (module docstring).
    """

    def __init__(self, model, optimizer, mesh=None,
                 loss_fn: Optional[Callable] = None, zero_stage: int = 1,
                 plan=None, device=None, numerics: bool = False,
                 min_shard_numel: int = 1024):
        if plan is not None:
            _refuse(plan)
            zero_stage = plan.zero_stage
            optimizer = plan.optimizer or optimizer
            numerics = numerics or bool(getattr(plan, "numerics", False))
            min_shard_numel = plan.zero_min_numel
        if zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be 0..3, got {zero_stage}")
        self.device = _resolve_mesh(mesh, device)
        self.mesh = mesh if isinstance(mesh, HybridMesh) else None
        named = sorted(model.named_parameters())
        off = [k for k, t in named + list(model.named_buffers())
               if t.device != self.device]
        if off:
            raise ValueError(f"parameters or buffers {off[:3]} are not on "
                             f"{self.device}; build the model there")
        self.model = model
        self.optimizer = optimizer
        self.plan = plan
        self.zero_stage = zero_stage
        self._step_count = 0
        # sorted by name: the order of the JAX path's pytree leaves, which
        # the global-norm clip sums in
        self._names = [k for k, p in named if p.requires_grad]
        self._params = [p for _, p in named if p.requires_grad]
        # several ranks: this rank's layout, shards and collectives
        self._layout = None
        if self.mesh is not None and self.mesh.size > 1:
            self._layout = self._hybrid_layout(model, optimizer, plan,
                                               zero_stage, min_shard_numel)
        # the tensors the optimizer updates: the parameters, or the ZeRO
        # shards that stand for them
        self._upd = (self._layout.update_tensors() if self._layout
                     else list(self._params))
        by_param = {id(p): u for p, u in zip(self._params, self._upd)}
        # the model's order, in which the JAX step's init_state makes the
        # optimizer's slots (Dpsgd numbers its noise streams so)
        self._slot_order = [by_param[id(p)] for p in model.parameters()
                            if p.requires_grad]

        amp_cfg = plan.amp if plan is not None else None
        self._amp_cfg = amp_cfg
        self._use_scaler = bool(
            amp_cfg is not None and amp_cfg.dtype == "float16"
            and amp_cfg.use_dynamic_loss_scaling)
        self._accum_k = plan.accumulate_steps if plan is not None else 1
        self._merge_avg = plan.gradient_merge_avg if plan is not None \
            else True
        use_remat = bool(plan is not None and plan.remat)
        # selective recompute wraps the named sublayers instead of the
        # whole loss; parallelize() pre-wraps, but a step built directly
        # must wrap them itself: remat is never silently dropped
        if use_remat and plan.recompute_checkpoints:
            already = any(getattr(sub.forward, "_is_remat_wrapped", False)
                          for sub in model.modules())
            if already or apply_selective_remat(model,
                                                plan.recompute_checkpoints):
                use_remat = False
            else:
                warnings.warn(
                    "recompute_configs.checkpoints matched no sublayer of "
                    f"{type(model).__name__}; falling back to whole-loss "
                    "recompute", stacklevel=2)
        self._fp16_ar = getattr(plan, "fp16_allreduce_dtype", None) \
            if plan is not None else None
        if plan is not None and plan.sequence_parallel:
            warnings.warn(
                "strategy requests sequence_parallel but the mesh has no "
                "`sep` axis (set hybrid_configs.sep_degree > 1); the step "
                "will run WITHOUT sequence parallelism", stacklevel=2)
        self._offload = bool(plan is not None and plan.zero_offload)
        self._host_slots = {}     # param -> {slot: host buffer} (offload)

        # extra step state, on the device: the gradient-merge accumulator
        # and its count, the loss scale and its counters (the JAX step's
        # extras, keyed alike; the accumulator by parameter name)
        dev = self.device
        extras = {}
        if self._accum_k > 1:
            extras["accum"] = {k: torch.zeros_like(p) for k, p in
                               zip(self._names, self._upd)}
            extras["accum_n"] = torch.zeros((), dtype=torch.int32,
                                            device=dev)
        if self._use_scaler:
            extras["loss_scale"] = torch.tensor(
                float(amp_cfg.init_loss_scaling), dtype=torch.float32,
                device=dev)
            extras["good_steps"] = torch.zeros((), dtype=torch.int32,
                                               device=dev)
            extras["bad_steps"] = torch.zeros((), dtype=torch.int32,
                                              device=dev)
        # the numerics observatory's in-step telemetry, under the JAX keys
        self.numerics_armed = bool(numerics)
        self._param_sizes = {k: int(np.prod(shape)) or 1 for k, shape in zip(
            self._names, [lf.local_shape for lf in self._layout.leaves]
            if self._layout else [p.shape for p in self._params])}
        self._step_rng: Dict[int, tuple] = {}  # armed: the RNG state each
        #                                        step of the last call began
        #                                        from, for the blame probe
        if self.numerics_armed:
            self._num_groups = telemetry_groups(self._names)
            self._num_index = torch.tensor(
                group_index(self._num_groups, self._names),
                dtype=torch.int64, device=dev)
            extras["numerics"] = {
                k: torch.zeros((), dtype=torch.float32, device=dev)
                for k in telemetry_keys(self._num_groups)}
        self._extras = extras

        if amp_cfg is not None:
            from ..amp import auto_cast

            def amp_ctx():
                return auto_cast(True,
                                 custom_white_list=amp_cfg.custom_white_list,
                                 custom_black_list=amp_cfg.custom_black_list,
                                 dtype=amp_cfg.dtype)
        else:
            amp_ctx = None
        compute_loss = make_compute_loss(model, loss_fn, amp_ctx)
        if use_remat:
            # the coarsest checkpointing: keep only the step's inputs and
            # run the whole forward again in the backward (the JAX step's
            # jax.checkpoint around its loss)
            inner = compute_loss

            def compute_loss(*arrays):
                return recompute(inner, *arrays, use_reentrant=False)
        self._compute_loss = compute_loss

    def _hybrid_layout(self, model, optimizer, plan, zero_stage,
                       min_numel):
        """Check what several ranks cannot run, put the hybrid clip in
        place of a global-norm clip, and build the layout."""
        from ..distributed.fleet.hybrid_parallel_optimizer import \
            HybridParallelClipGrad
        from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm
        mesh = self.mesh
        for ax, why in (("pipe", "pipeline"), ("sep", "sep"), ("ep", "ep")):
            if mesh.shape.get(ax, 1) > 1:
                raise NotImplementedError(f"a {ax} axis: {_ITEM8[why]}")
        ba = _batch_axes(mesh)
        if ba is not None and any(True for _ in model.buffers()):
            raise NotImplementedError(_ITEM8["buffers"])
        if ba is not None and plan is not None and \
                getattr(plan, "comm_quant", None) is not None:
            raise NotImplementedError(f"strategy.quant_allreduce: "
                                      f"{_ITEM8['comm_quant']}")
        sharded = mesh.shape.get("model", 1) > 1 or (
            zero_stage >= 1 and mesh.shape.get("sharding", 1) > 1)
        if sharded and type(optimizer).__name__ in ("Lamb", "LarsMomentum"):
            raise NotImplementedError(f"{type(optimizer).__name__}: "
                                      f"{_ITEM8['trust']}")
        clip = optimizer._grad_clip
        if isinstance(clip, ClipGradByGlobalNorm):
            optimizer._grad_clip = HybridParallelClipGrad(clip, mesh.hcg)
        elif isinstance(clip, ClipGradByNorm) and sharded:
            raise NotImplementedError(f"ClipGradByNorm {_ITEM8['trust']}")
        return HybridLayout(mesh, self._params, zero_stage, min_numel)

    def _stage(self, a, batch_dim=0):
        """An input on the step's device; with several ranks, this rank's
        slice of the global batch along `batch_dim`."""
        t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
        if self._layout is not None:
            t = self._layout.local_batch(t, batch_dim)
        return t.to(self.device, non_blocking=True)

    # ---- the step ----
    def _grads(self, scale):
        """The gradients after the backward: unscaled in fp32 and back to
        each gradient's dtype (with a loss scale), with several ranks
        averaged over the batch ranks (and this rank's ZeRO slice), then
        rounded through fp16 where fp16_allreduce asks. None where a
        parameter has none."""
        grads = [p.grad for p in self._params]
        for p in self._params:
            p.grad = None
        if scale is not None:
            grads = [None if g is None else (g.float() / scale).to(g.dtype)
                     for g in grads]
        if self._layout is not None:
            grads = self._layout.sync_grads(grads)
        if self._fp16_ar is not None:
            grads = [g.half().to(g.dtype)
                     if g is not None and g.dtype == torch.float32 else g
                     for g in grads]
        return grads

    def _scale_update(self, grads):
        """The dynamic loss scale's step on the device: the finite census,
        the counters, the new scale (in fp32), and non-finite gradients
        zeroed. Returns (grads, finite)."""
        cfg, ex = self._amp_cfg, self._extras
        finite = all_finite([g for g in grads if g is not None])
        if self._layout is not None:
            finite = self._layout.agree_finite(finite)
        scale = ex["loss_scale"]
        good = torch.where(finite, ex["good_steps"] + 1, 0).int()
        bad = torch.where(finite, 0, ex["bad_steps"] + 1).int()
        grow = good >= cfg.incr_every_n_steps
        shrink = bad >= cfg.decr_every_n_nan_or_inf
        ex["loss_scale"] = torch.where(
            shrink, torch.clamp_min(scale * cfg.decr_ratio, 1.0),
            torch.where(grow, scale * cfg.incr_ratio, scale))
        ex["good_steps"] = torch.where(grow, 0, good).int()
        ex["bad_steps"] = torch.where(shrink, 0, bad).int()
        grads = [None if g is None else torch.where(finite, g, 0.0).to(g.dtype)
                 for g in grads]
        return grads, finite

    def _leaf_norms(self, tensors):
        """Each tensor's l2 norm as a 0-d fp32 tensor (0 for None), in one
        multi-tensor pass."""
        have = [t for t in tensors if t is not None]
        norms = iter(torch._foreach_norm(have, 2, dtype=torch.float32)
                     if have else ())
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        return [next(norms) if t is not None else zero for t in tensors]

    def _train_step(self, arrays, lr, step=None, telemetry=True):
        """One step on staged arrays with lr a 0-d fp32 tensor on the
        device and `step` the 1-based global step (gradient merge applies
        where step % k == 0). Returns the detached (unscaled) loss. An
        armed step computes the telemetry when `telemetry` is set."""
        if step is None:
            step = self._step_count
        if self.numerics_armed:
            self._step_rng[step] = rng_snapshot()
        scale = self._extras.get("loss_scale")
        if self._layout is not None:
            self._layout.before_forward()
        loss = self._compute_loss(*arrays)
        (loss if scale is None else loss * scale).backward()
        grads = self._grads(scale)
        finite = None
        if self._use_scaler:
            grads, finite = self._scale_update(grads)
        old = None
        if self.numerics_armed and telemetry:
            # the gradients the JAX telemetry reads (unscaled, before the
            # merge and the clip) and a copy of the parameters before the
            # update (a multi-tensor op, not a copy a leaf)
            gn = self._leaf_norms(grads)
            old = torch._foreach_mul([p.detach() for p in self._upd], 1.0)
        do_apply = True
        if self._accum_k > 1:
            # bank every step (the accumulator in the parameter's dtype);
            # accum_n counts the finite ones, so a window that lost a step
            # to an overflow averages over what it banked
            acc = self._extras["accum"]
            for k, g in zip(self._names, grads):
                if g is not None:
                    acc[k].add_(g)
            n = self._extras["accum_n"]
            self._extras["accum_n"] = n + (1 if finite is None
                                           else finite.int())
            do_apply = step % self._accum_k == 0
            if do_apply:
                denom = (self._extras["accum_n"].clamp_min(1).float()
                         if self._merge_avg else 1.0)
                grads = [acc[k] / denom for k in self._names]
        if do_apply:
            self._update(grads, lr, finite)
            if self._accum_k > 1:
                # clear only what applied: an fp16 overflow on the k-th
                # step keeps the banked gradients for the next boundary
                for a in self._extras["accum"].values():
                    if finite is None:
                        a.zero_()
                    else:
                        a.masked_fill_(finite, 0)
                self._extras["accum_n"] = (
                    torch.zeros_like(self._extras["accum_n"])
                    if finite is None else
                    torch.where(finite, 0, self._extras["accum_n"]).int())
        if old is not None:
            self._extras["numerics"] = self._telemetry(gn, old)
        if self._layout is not None:
            self._layout.after_update()
            return self._layout.mean_loss(loss)
        return loss.detach()

    def _telemetry(self, gn, old):
        """The telemetry dict from the gradients' leaf norms and the
        parameters before the update (`old`, consumed: it becomes old -
        new in place): the leaves' squares summed a group in one
        index_add over the four families."""
        new = [p.detach() for p in self._upd]
        fp32 = torch.float32
        wn = torch._foreach_norm(old, 2, dtype=fp32)
        pn = torch._foreach_norm(new, 2, dtype=fp32)
        torch._foreach_sub_(old, new)
        dn = torch._foreach_norm(old, 2, dtype=fp32)
        sq = torch.stack([torch.stack(n) for n in (gn, pn, wn, dn)]).square()
        sums = torch.zeros((4, len(self._num_groups)), dtype=fp32,
                           device=self.device).index_add_(
                               1, self._num_index, sq)
        return in_step_telemetry(self._num_groups, *sums)

    def _update(self, grads, lr, do_update):
        """Clip and update, gated by `do_update` (None: always), with the
        optimizer state staged in from the host around it under offload."""
        if self._slot_order:
            self.optimizer.init_slots(self._slot_order)
            self._slot_order = None
        if self._offload:
            self._stage_state(self.device)
        self.optimizer.apply_gradients(
            list(zip(self._upd, grads)), lr, names=self._names,
            do_update=do_update)
        if self._offload:
            self._stage_state(None)

    def _stage_state(self, device):
        """Move every optimizer slot to `device`, or (None) to its host
        buffer: pinned memory beside a CUDA step, reused every update."""
        for p, slots in self.optimizer.state.items():
            for k, t in slots.items():
                if device is not None:
                    slots[k] = t.to(device, non_blocking=True)
                    continue
                if t.device.type == "cpu":
                    continue
                host = self._host_slots.setdefault(p, {})
                buf = host.get(k)
                if buf is None:
                    buf = host[k] = torch.empty(t.shape, dtype=t.dtype,
                                                pin_memory=True)
                buf.copy_(t, non_blocking=True)
                slots[k] = buf

    def __call__(self, *args):
        arrays = [self._stage(a) for a in args]
        self._step_count += 1
        lr = torch.tensor(self.optimizer.get_lr(), dtype=torch.float32,
                          device=self.device)
        self._step_rng.clear()
        return self._train_step(arrays, lr, self._step_count)

    @property
    def loss_scale(self):
        """The dynamic loss scale as a float (a host read), or None."""
        s = self._extras.get("loss_scale")
        return None if s is None else float(s)

    # ---- numerics observatory hooks (obs/numerics.py) ----
    def numerics_host_sample(self) -> Optional[Dict[str, float]]:
        """Host view of the telemetry the armed step left in
        `_extras["numerics"]`, with the AMP loss scale and its good and
        bad counters when present: one copy of a few scalars. None when
        the step was built without numerics."""
        tele = self._extras.get("numerics")
        if tele is None:
            return None
        keys = list(tele) + [k for k in ("loss_scale", "good_steps",
                                         "bad_steps") if k in self._extras]
        vals = torch.stack([tele[k] if k in tele else
                            self._extras[k].float() for k in keys])
        return dict(zip(keys, vals.cpu().tolist()))

    def nonfinite_blame(self, step: int, *args) -> Dict:
        """Per-leaf non-finite census on the current parameters and the
        given one-step batch: the step's own loss (its autocast and
        recompute) differentiated with `torch.autograd.grad`, no update.
        Returns ``{"loss": float, "sizes": {name: numel}, "grads": {name:
        count>0}, "params": {name: count>0}, "probe_seconds": float}``,
        as the JAX probe does. It leaves the live gradients, the
        optimizer state, the model's buffers (BatchNorm statistics) and
        the RNG state as they were; the forward runs on the RNG state
        that step `step` began from when the armed step kept it (the
        steps of its last call), so dropout masks are that step's."""
        t0 = time.perf_counter()
        arrays = [self._stage(a) for a in args]
        if self._layout is not None:
            self._layout.before_forward()
        rng_now = rng_snapshot()
        buffers = [(b, b.detach().clone()) for b in self.model.buffers()]
        at = self._step_rng.get(int(step))
        if at is not None:
            rng_restore(at)
        try:
            loss = self._compute_loss(*arrays)
            grads = torch.autograd.grad(loss, self._params,
                                        allow_unused=True)
            zero = torch.zeros((), dtype=torch.int32, device=self.device)
            counts = torch.stack(
                [nonfinite_count(g) if g is not None else zero
                 for g in grads]
                + [nonfinite_count(p.detach()) for p in self._params])
            # one copy back; float64 holds every count exactly
            host = torch.cat([loss.detach().double().reshape(1),
                              counts.double()]).cpu().tolist()
        finally:
            rng_restore(rng_now)
            with torch.no_grad():
                for b, v in buffers:
                    b.copy_(v)
            if self._layout is not None and self._layout.zero_stage >= 3:
                self._layout.release_params()
        n = len(self._names)
        g, p = host[1:1 + n], host[1 + n:]
        return {
            "loss": host[0],
            "sizes": dict(self._param_sizes),
            "grads": {k: int(c) for k, c in zip(self._names, g) if c},
            "params": {k: int(c) for k, c in zip(self._names, p) if c},
            "probe_seconds": round(time.perf_counter() - t0, 6),
        }

    def state_dict(self):
        """The model's state_dict; with several ranks every parameter
        whole (the logical state), on every rank."""
        if self._layout is not None:
            return self._layout.full_state(self.model)
        return self.model.state_dict()


class ScanTrainStep(ShardedTrainStep):
    """K train steps over one stacked chunk of inputs.

    usage:
        step = ScanTrainStep(model, opt, scan_steps=8)
        losses = step(ids_chunk, labels_chunk)   # [K, ...] stacked inputs
        # losses: [K] fp32 on the device, one per step
        step.lr_vector                           # [K] lrs the chunk used

    A plan's `scan_steps` > 1 sets K. Gradient-merge boundaries follow the
    global step index, so k_steps need not divide K.
    """

    def __init__(self, model, optimizer, mesh=None, scan_steps: int = 8,
                 loss_fn: Optional[Callable] = None, zero_stage: int = 1,
                 plan=None, device=None, numerics: bool = False,
                 min_shard_numel: int = 1024):
        if plan is not None and getattr(plan, "scan_steps", 1) > 1:
            scan_steps = plan.scan_steps
        super().__init__(model, optimizer, mesh, loss_fn=loss_fn,
                         zero_stage=zero_stage, plan=plan, device=device,
                         numerics=numerics, min_shard_numel=min_shard_numel)
        self.scan_steps = int(scan_steps)
        if self.scan_steps < 1:
            raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
        self.dispatch_count = 0
        self.lr_vector = None     # the last chunk's [K] lrs, numpy fp32
        # goodput ledger (obs.goodput) — caller-thread H2D staging books
        # to the "h2d" phase; None keeps the hook at one predicate
        self.ledger = None

    def device_put_chunk(self, stacked):
        """Start the copy of one stacked chunk (`[K, ...]` host arrays or
        tensors) to the step's device and return the device tensors (the
        JAX `device_put_chunk`, api.py:868): each array is staged in
        pinned memory and copied non-blocking, so `io.ChunkPrefetcher`,
        which calls this as its `put_fn` from its thread, overlaps the
        next chunk's copy with this chunk's compute. On the CPU the
        arrays are wrapped, not copied."""
        out = []
        for a in stacked:
            t = a if torch.is_tensor(a) else torch.from_numpy(
                np.ascontiguousarray(a))
            if self.device.type == "cuda":
                if t.device.type == "cpu" and not t.is_pinned():
                    t = t.pin_memory()
                t = t.to(self.device, non_blocking=True)
            out.append(t)
        return tuple(out)

    def _lr_vector(self, K):
        """Length-K per-step LR schedule: constant with a float lr; an
        LRScheduler is advanced once per step (its current value first)."""
        sched = self.optimizer._lr_scheduler
        if sched is None:
            return np.full((K,), float(self.optimizer.get_lr()), np.float32)
        vals = []
        for _ in range(K):
            vals.append(float(sched()))
            sched.step()
        return np.asarray(vals, np.float32)

    def __call__(self, *args):
        K = self.scan_steps
        if self.ledger is not None:
            with self.ledger.measure("h2d"):
                arrays = [self._stage(a, 1) for a in args]
        else:
            arrays = [self._stage(a, 1) for a in args]
        for a in arrays:
            if a.ndim < 1 or a.shape[0] != K:
                raise ValueError(
                    f"ScanTrainStep expects stacked [K={K}, ...] inputs; got "
                    f"shape {tuple(a.shape)} (stack per-step batches with "
                    "parallel.stack_batches)")
        self.lr_vector = self._lr_vector(K)
        lr_dev = torch.from_numpy(self.lr_vector).to(self.device)
        first = self._step_count + 1
        self._step_count += K
        losses = torch.empty((K,), dtype=torch.float32, device=self.device)
        self._step_rng.clear()
        for i in range(K):
            losses[i] = self._train_step([a[i] for a in arrays], lr_dev[i],
                                         first + i, i == K - 1)
        self.dispatch_count += 1
        return losses


def stack_batches(batches):
    """Stack K per-step batches (each a tuple/list of arrays, or one array)
    into the [K, ...] chunk layout ScanTrainStep takes, as numpy."""
    if not batches:
        raise ValueError("stack_batches needs at least one batch")

    def host(a):
        return a.detach().cpu().numpy() if torch.is_tensor(a) \
            else np.asarray(a)

    first = batches[0]
    if isinstance(first, (tuple, list)):
        return tuple(np.stack([host(b[j]) for b in batches])
                     for j in range(len(first)))
    return (np.stack([host(b) for b in batches]),)


def parallelize(model, optimizer=None, mesh=None, strategy=None,
                loss_fn=None, device=None):
    """The fleet entry (fleet.distributed_model + distributed_optimizer +
    minimize): compile `strategy` (StrategyCompiler) and return the train
    step that executes it, a ScanTrainStep when the plan's scan_steps > 1.
    `mesh`: None (the hybrid group's, after fleet.init), one device or a
    HybridMesh; `device` as the steps take it. What the step cannot run
    raises before the model is touched."""
    from ..distributed.fleet.strategy_compiler import StrategyCompiler
    if mesh is None and device is None:
        mesh = get_mesh()
    plan = StrategyCompiler().compile(strategy, optimizer, mesh)
    _refuse(plan, strategy)
    if strategy is not None:
        _check_group(strategy, mesh)
    if plan.sync_batch_norm:
        from ..nn.layer.norm import SyncBatchNorm
        model = SyncBatchNorm.convert_sync_batchnorm(model)
    if plan.remat and plan.recompute_checkpoints:
        if not apply_selective_remat(model, plan.recompute_checkpoints):
            warnings.warn(
                "recompute_configs.checkpoints matched no sublayer of "
                f"{type(model).__name__}; falling back to whole-loss "
                "recompute", stacklevel=2)
            plan.recompute_checkpoints = []
    if plan.scan_steps > 1:
        return ScanTrainStep(model, optimizer, mesh, loss_fn=loss_fn,
                             plan=plan, device=device)
    return ShardedTrainStep(model, optimizer, mesh, loss_fn=loss_fn,
                            plan=plan, device=device)
