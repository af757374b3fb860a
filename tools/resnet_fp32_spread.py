#!/usr/bin/env python3
"""How far fp32 rounding alone moves resnet50's training, on the CPU.

    python3 tools/resnet_fp32_spread.py [--threads 8,1] [--steps 3]

Runs the same resnet50 (1000 classes, training mode, weights from seed
13) on the same 8 x 3 x 64 x 64 batch twice on the CPU, once with each of
two thread counts, so that only the order of the fp32 sums differs, and
prints one JSON line: the gradient norms' largest and median relative
difference after one forward and backward, the share of weights more
than lr / 10 apart after one AdamW step (lr 1e-4, wd 0.01) from the same
state, and the losses and that share after `--steps` steps. These are
the spreads `chip_smoke.py`'s resnet_model phase sets its fp32 limits
against. The port's plain versions only; no GPU is used.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def run(threads, steps, x, y, lr):
    import torch
    from paddle_tpu_torch.bridge import export_state
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ScanTrainStep, stack_batches
    from paddle_tpu_torch.vision.models import resnet50
    torch.set_num_threads(threads)

    def fresh():
        gen = torch.Generator().manual_seed(13)
        return resnet50(device="cpu", generator=gen)

    m = fresh()
    CrossEntropyLoss()(m(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    norms = {k: float(p.grad.double().norm()) for k, p in
             m.named_parameters()}
    out = {"norms": norms}
    for k in (1, steps):
        m = fresh()
        step = ScanTrainStep(m, AdamW(learning_rate=lr, weight_decay=0.01,
                                      parameters=m.parameters()),
                             scan_steps=k, loss_fn=CrossEntropyLoss(),
                             device="cpu")
        losses = step(*stack_batches([(x, y)] * k))
        out[k] = (losses.tolist(), export_state(m))
    return out


def far_share(a, b, lr):
    far = sum(int((np.abs(a[k] - b[k]) > lr / 10).sum()) for k in a)
    return far / sum(v.size for v in a.values())


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", default="8,1")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    lr = 1e-4
    rng = np.random.RandomState(13)
    x = rng.standard_normal((8, 3, 64, 64)).astype(np.float32)
    y = rng.randint(0, 1000, (8,)).astype(np.int64)
    t1, t2 = (int(t) for t in args.threads.split(","))
    a, b = run(t1, args.steps, x, y, lr), run(t2, args.steps, x, y, lr)
    rel = [abs(a["norms"][k] - b["norms"][k]) / b["norms"][k]
           for k in a["norms"]]
    print(json.dumps({
        "threads": [t1, t2], "lr": lr,
        "grad_norm_max_rel_diff": max(rel),
        "grad_norm_median_rel_diff": float(np.median(rel)),
        "one_step_share_past_lr_over_10": far_share(a[1][1], b[1][1], lr),
        f"losses_after_{args.steps}_steps": [a[args.steps][0],
                                             b[args.steps][0]],
        f"share_past_lr_over_10_after_{args.steps}_steps": far_share(
            a[args.steps][1], b[args.steps][1], lr)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
