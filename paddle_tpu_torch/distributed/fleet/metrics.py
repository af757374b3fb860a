"""Metrics across ranks (counterpart of
paddle_tpu/distributed/fleet/metrics.py): each function takes this
rank's statistic (a number, numpy array or tensor), reduces it over
every rank of the world (sum, max or min) and returns numpy; `acc`,
`mae`, `mse` and `rmse` divide two global sums, and `auc` sweeps the
global positive and negative bucket histograms. In one process the
values are returned as they are. The reduction runs in float64 on this
rank's device."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from .. import collective as C
from ..parallel_env import get_world_size


def _reduce(value, mode: str):
    arr = np.asarray(value.detach().cpu().numpy() if torch.is_tensor(value)
                     else value)
    if get_world_size() <= 1:
        return arr
    from ..parallel_env import current_device
    t = torch.tensor(arr, dtype=torch.float64, device=current_device())
    op = {"sum": C.ReduceOp.SUM, "max": C.ReduceOp.MAX,
          "min": C.ReduceOp.MIN}[mode]
    C.all_reduce(t, op)
    return t.cpu().numpy()


def sum(input, scope=None, util=None):  # noqa: A001 (reference name)
    """The element-wise sum of a local statistic over every rank."""
    return _reduce(input, "sum")


def max(input, scope=None, util=None):  # noqa: A001
    return _reduce(input, "max")


def min(input, scope=None, util=None):  # noqa: A001
    return _reduce(input, "min")


def acc(correct, total, scope=None, util=None):
    """Global accuracy from local (correct, total) counters."""
    return np.float64(_reduce(correct, "sum")) / np.float64(
        _reduce(total, "sum"))


def mae(abserr, total_ins_num, scope=None, util=None):
    return np.float64(_reduce(abserr, "sum")) / np.float64(
        _reduce(total_ins_num, "sum"))


def mse(sqrerr, total_ins_num, scope=None, util=None):
    return np.float64(_reduce(sqrerr, "sum")) / np.float64(
        _reduce(total_ins_num, "sum"))


def rmse(sqrerr, total_ins_num, scope=None, util=None):
    return np.sqrt(mse(sqrerr, total_ins_num))


def auc(stat_pos, stat_neg, scope=None, util=None):
    """Global AUC from each rank's positive and negative prediction-bucket
    counts: both histograms summed, then the trapezoid sweep from the
    highest bucket down (0.5 without both classes)."""
    pos = np.asarray(_reduce(stat_pos, "sum"), np.float64).ravel()
    neg = np.asarray(_reduce(stat_neg, "sum"), np.float64).ravel()
    area = 0.0
    tp = fp = 0.0
    for i in builtins.range(len(pos) - 1, -1, -1):
        new_tp = tp + pos[i]
        new_fp = fp + neg[i]
        area += (new_fp - fp) * (tp + new_tp) / 2.0
        tp, fp = new_tp, new_fp
    if tp == 0 or fp == 0:
        return 0.5
    return float(area / (tp * fp))
