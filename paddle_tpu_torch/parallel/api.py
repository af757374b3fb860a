"""Train steps on one GPU (counterpart of paddle_tpu/parallel/api.py).

`ShardedTrainStep` runs one step: forward, backward, clip, then update,
in the order of the JAX package's `train_step` (api.py:473-600).
`ScanTrainStep` runs K such steps over stacked `[K, ...]` inputs, with the
JAX runner's per-step learning-rate vector and global steps 1..K, and
returns the `[K]` fp32 loss vector, which stays on the device (nothing in
the chunk waits for the host). The JAX runner fuses the K steps into one
compiled dispatch; here they run eagerly, one after another, and
`dispatch_count` counts chunks. A CUDA graph of the chunk is later work.

The model's parameters are updated in place (see optimizer/optimizer.py);
`state_dict()` is the model's. The gradients are dropped after every
update. `mesh` is None or one device, so any `zero_stage` shards nothing;
a mesh over more devices and strategy plans (AMP, recompute, gradient
merge) wait for the multi-GPU slice and raise. The step runs on CUDA
unless `device="cpu"` (or a one-device CPU mesh) is given, and raises
without a GPU otherwise.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.device import resolve_device

_MULTI_GPU = "waits for the multi-GPU slice (ROADMAP §1)"


def _resolve_mesh(mesh, device) -> torch.device:
    """None, a device, or a one-device sequence -> torch.device."""
    if isinstance(mesh, (list, tuple)):
        if len(mesh) != 1:
            raise NotImplementedError(
                f"a mesh over {len(mesh)} devices {_MULTI_GPU}")
        mesh = mesh[0]
    if mesh is not None and device is not None and \
            resolve_device(mesh) != resolve_device(device):
        raise ValueError(f"mesh {mesh!r} and device {device!r} disagree")
    return resolve_device(device if device is not None else mesh)


def make_compute_loss(model, loss_fn=None):
    """(*arrays) -> fp32 loss. loss_fn=None means the model returns its own
    scalar loss (causal-LM style: model(input_ids, labels))."""

    def compute_loss(*arrays):
        if loss_fn is None:
            loss = model(*arrays)
        else:
            loss = loss_fn(model(arrays[0]), *arrays[1:])
        return loss.float()

    return compute_loss


class ShardedTrainStep:
    """One train step (forward, backward, clip, update) on one device.

    usage:
        step = ShardedTrainStep(model, optimizer)   # CUDA by default
        loss = step(input_ids, labels)              # 0-d fp32 on the device
    """

    def __init__(self, model, optimizer, mesh=None,
                 loss_fn: Optional[Callable] = None, zero_stage: int = 1,
                 plan=None, device=None):
        if plan is not None:
            raise NotImplementedError(
                f"strategy plans (AMP, recompute, gradient merge) "
                f"{_MULTI_GPU}")
        if zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be 0..3, got {zero_stage}")
        self.device = _resolve_mesh(mesh, device)
        named = sorted(model.named_parameters())
        off = [k for k, p in named if p.device != self.device]
        if off:
            raise ValueError(f"parameters {off[:3]} are not on "
                             f"{self.device}; build the model there")
        self.model = model
        self.optimizer = optimizer
        self._step_count = 0
        # sorted by name: the order of the JAX path's pytree leaves, which
        # the global-norm clip sums in
        self._params = [p for _, p in named if p.requires_grad]
        self._compute_loss = make_compute_loss(model, loss_fn)

    def _stage(self, a):
        t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
        return t.to(self.device, non_blocking=True)

    def _train_step(self, arrays, lr):
        """One step on staged arrays. Returns the detached loss."""
        loss = self._compute_loss(*arrays)
        loss.backward()
        self.optimizer.apply_gradients(
            [(p, p.grad) for p in self._params], lr)
        for p in self._params:
            p.grad = None
        return loss.detach()

    def __call__(self, *args):
        arrays = [self._stage(a) for a in args]
        self._step_count += 1
        return self._train_step(arrays, self.optimizer.get_lr())

    def state_dict(self):
        return self.model.state_dict()


class ScanTrainStep(ShardedTrainStep):
    """K train steps over one stacked chunk of inputs.

    usage:
        step = ScanTrainStep(model, opt, scan_steps=8)
        losses = step(ids_chunk, labels_chunk)   # [K, ...] stacked inputs
        # losses: [K] fp32 on the device, one per step
    """

    def __init__(self, model, optimizer, mesh=None, scan_steps: int = 8,
                 loss_fn: Optional[Callable] = None, zero_stage: int = 1,
                 plan=None, device=None):
        super().__init__(model, optimizer, mesh, loss_fn=loss_fn,
                         zero_stage=zero_stage, plan=plan, device=device)
        self.scan_steps = int(scan_steps)
        if self.scan_steps < 1:
            raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
        self.dispatch_count = 0

    def _lr_vector(self, K):
        """The per-step learning rates: constant with a float lr."""
        return np.full((K,), float(self.optimizer.get_lr()), np.float32)

    def __call__(self, *args):
        K = self.scan_steps
        arrays = [self._stage(a) for a in args]
        for a in arrays:
            if a.ndim < 1 or a.shape[0] != K:
                raise ValueError(
                    f"ScanTrainStep expects stacked [K={K}, ...] inputs; got "
                    f"shape {tuple(a.shape)} (stack per-step batches with "
                    "parallel.stack_batches)")
        lr_vec = self._lr_vector(K)
        self._step_count += K
        losses = torch.empty((K,), dtype=torch.float32, device=self.device)
        for i in range(K):
            losses[i] = self._train_step([a[i] for a in arrays],
                                         float(lr_vec[i]))
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
