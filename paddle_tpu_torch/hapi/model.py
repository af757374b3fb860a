"""Keras-style high-level Model (counterpart of paddle_tpu/hapi/model.py;
reference: python/paddle/hapi/model.py:878 — prepare:1450, fit:1523,
evaluate, predict, train_batch:1015).

What the JAX `Model` does, step for step: an eager step a batch (forward,
`loss.backward()`, `optimizer.step()`, then the gradients dropped), the
metrics updated from the step's outputs, and `loss.item()`; `fit` drives
it over an `io.DataLoader` with the callbacks of `config_callbacks`.
Each batch is moved to the network's device (the device of its first
parameter) before the forward, non-blocking from the loader's pinned
memory; a network on the card never runs its batches on the CPU.

A train step waits for the card twice, as the JAX one does: the
metrics' `compute` reads the outputs to the host, then `loss.item()`.
`host_sync_s` sums the host seconds spent in each of the two, over every
`train_batch` since the Model was made.
"""
from __future__ import annotations

import itertools
import os
import time
from typing import List

import numpy as np
import torch

from ..core.device import resolve_device
from ..framework_io import load as _load
from ..framework_io import save as _save
from ..io import DataLoader
from ..metric import Metric
from ..nn.layer.layers import paddle_state_dict, set_state_dict
from .callbacks import config_callbacks


def summary(net, input_size=None, dtypes=None):
    """paddle.summary: print and return the parameter counts of `net`."""
    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    print(f"Total params: {total:,}\nTrainable params: {trainable:,}")
    return {"total_params": total, "trainable_params": trainable}


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False
        self.host_sync_s = {"metrics": 0.0, "loss": 0.0}

    @property
    def device(self) -> torch.device:
        """The network's device: that of its first parameter or buffer
        (the first GPU for a network that holds neither)."""
        for t in itertools.chain(self.network.parameters(),
                                 self.network.buffers()):
            return t.device
        return resolve_device(None)

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        if amp_configs is not None:
            raise NotImplementedError(
                "Model.prepare(amp_configs=...): the JAX Model ignores it; "
                "train under AMP through parallel.parallelize")
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, (list, tuple)):
            self._metrics = list(metrics)
        else:
            self._metrics = [metrics]
        return self

    # ---- single-batch ops (train_batch:1015 analog) ----
    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        inputs = self._on_device(inputs)
        labels = self._on_device(labels)
        outputs = self.network(*inputs)
        loss = self._loss(outputs, *labels)
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad(set_to_zero=False)
        t0 = time.perf_counter()
        metrics = self._update_metrics(outputs, labels)
        t1 = time.perf_counter()
        value = float(loss.item())
        t2 = time.perf_counter()
        self.host_sync_s["metrics"] += t1 - t0
        self.host_sync_s["loss"] += t2 - t1
        return ([value], metrics) if metrics else [value]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = self._on_device(inputs)
        labels = self._on_device(labels)
        outputs = self.network(*inputs)
        loss = self._loss(outputs, *labels) if self._loss else None
        metrics = self._update_metrics(outputs, labels)
        out = [float(loss.item())] if loss is not None else []
        return (out, metrics) if metrics else out

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        out = self.network(*self._on_device(inputs))
        return [o.detach().cpu().numpy() if torch.is_tensor(o) else o
                for o in (out if isinstance(out, (list, tuple)) else [out])]

    def _update_metrics(self, outputs, labels):
        res = []
        for m in self._metrics:
            args = m.compute(outputs, *labels)
            if torch.is_tensor(args):
                args = [args]
            res.append(m.update(*args))
        return res

    # ---- fit / evaluate / predict ----
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        if accumulate_grad_batches != 1:
            raise NotImplementedError(
                "fit(accumulate_grad_batches > 1): the JAX Model ignores "
                "it; merge gradients through parallel.parallelize")
        train_loader = self._to_loader(train_data, batch_size, shuffle,
                                       drop_last, num_workers)
        eval_loader = (self._to_loader(eval_data, batch_size, False, False,
                                       num_workers)
                       if eval_data is not None else None)
        steps = len(train_loader) if hasattr(train_loader, "__len__") \
            else None
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=steps, verbose=verbose,
                                save_freq=save_freq, save_dir=save_dir,
                                metrics=["loss"] + [m.name()
                                                   for m in self._metrics])
        cbks.on_train_begin()
        self.stop_training = False
        logs = {}
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(train_loader):
                if num_iters is not None and step >= num_iters:
                    break
                cbks.on_train_batch_begin(step)
                inputs, labels = self._split_batch(batch)
                res = self.train_batch(inputs, labels)
                logs = self._pack_logs(res)
                cbks.on_train_batch_end(step, logs)
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, verbose=0, callbacks=cbks)
        cbks.on_train_end(logs)
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        loader = self._to_loader(eval_data, batch_size, False, False,
                                 num_workers)
        for m in self._metrics:
            m.reset()
        if callbacks is None or not hasattr(callbacks, "on_eval_begin"):
            callbacks = config_callbacks(None, model=self, verbose=0)
        callbacks.on_eval_begin()
        logs = {}
        losses = []
        for step, batch in enumerate(loader):
            if num_iters is not None and step >= num_iters:
                break
            callbacks.on_eval_batch_begin(step)
            inputs, labels = self._split_batch(batch)
            res = self.eval_batch(inputs, labels)
            loss_vals = res[0] if isinstance(res, tuple) else res
            if loss_vals:
                losses.append(loss_vals[0])
            callbacks.on_eval_batch_end(step, self._pack_logs(res))
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            logs[m.name()] = m.accumulate()
        callbacks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._to_loader(test_data, batch_size, False, False,
                                 num_workers)
        outputs = []
        for batch in loader:
            inputs, _ = self._split_batch(batch, has_labels=False)
            outputs.append(self.predict_batch(inputs))
        if stack_outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(n_out)]
        return outputs

    # ---- persistence ----
    def save(self, path, training=True):
        """`path.pdparams` (the network's parameters and buffers) and, with
        `training` and an optimizer, `path.pdopt` (its slots), in the JAX
        package's format."""
        _save(paddle_state_dict(self.network), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Load `path.pdparams` into the network, and `path.pdopt` (where
        it exists) into the optimizer unless `reset_optimizer`, onto the
        network's device."""
        dev = self.device
        set_state_dict(self.network, _load(path + ".pdparams", device=dev))
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            self._optimizer.set_state_dict(_load(opt_path, device=dev))

    def parameters(self):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtype)

    # ---- helpers ----
    def _on_device(self, x):
        """x (one item, a list or a tuple, or None) as a list, each tensor
        or numpy array on the network's device."""
        dev = self.device
        out = []
        for a in self._to_list(x):
            if isinstance(a, np.ndarray):
                a = torch.from_numpy(a)
            if torch.is_tensor(a):
                a = a.to(dev, non_blocking=True)
            out.append(a)
        return out

    @staticmethod
    def _to_list(x):
        if x is None:
            return []
        return list(x) if isinstance(x, (list, tuple)) else [x]

    @staticmethod
    def _to_loader(data, batch_size, shuffle, drop_last, num_workers):
        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers)

    @staticmethod
    def _split_batch(batch, has_labels=True):
        if isinstance(batch, (list, tuple)):
            if has_labels and len(batch) >= 2:
                return list(batch[:-1]), [batch[-1]]
            return list(batch), []
        return [batch], []

    @staticmethod
    def _pack_logs(res):
        if isinstance(res, tuple):
            losses, metrics = res
            logs = {"loss": losses[0]}
            for i, m in enumerate(metrics):
                logs[f"metric_{i}"] = (m if not isinstance(m, (list, tuple))
                                       else m[0])
            return logs
        return {"loss": res[0]}
