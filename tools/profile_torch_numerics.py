#!/usr/bin/env python3
"""What the numerics observatory's in-step telemetry costs a chunk of the
resilient_train cell, piece by piece, on one GPU.

    python3 tools/profile_torch_numerics.py [--reps N]

Builds `chip_smoke.py`'s train_numerics cell (`chip_smoke.
numerics_model()`: full gpt3-125m in bf16, AdamW with fp32 moments,
ScanTrainStep(scan_steps=2) built with numerics=True), runs three chunks,
then times, each the median of N repetitions (default 5) to a
synchronize:

- the copy of the parameters the armed step keeps before the update
  (one multi-tensor `_foreach_mul`), beside a `clone()` a leaf;
- the gradients' leaf norms (`_leaf_norms`: one multi-tensor norm);
- `_telemetry`: the three norms of the copy, the parameters and their
  difference, the sums a group (one `index_add`) and the dict;
- a chunk not armed and armed, in turns (off, on, on, off);
- `rng_snapshot()` (an armed step takes one a step for the blame probe)
  and `numerics_host_sample()`.

Prints JSON lines: the card (name and power limit from nvidia-smi), then
the readings in ms.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_numerics: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.core.random import rng_snapshot
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    model, _, step = cs.numerics_model()
    step.capture_at = step.poison_after = None
    ids, labels = cs.resilient_batches(model.config.vocab_size)
    K = step.scan_steps

    def chunk():
        step(ids[:K], labels[:K])

    for _ in range(3):
        chunk()

    def ms(fn, reps=args.reps):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    params = [p.detach() for p in step._params]
    grads = [torch.randn_like(p) for p in params]
    res = {
        "leaves": len(params),
        "copy_foreach_ms": ms(lambda: torch._foreach_mul(params, 1.0)),
        "copy_a_leaf_ms": ms(lambda: [p.clone() for p in params]),
        "grad_leaf_norms_ms": ms(lambda: step._leaf_norms(grads)),
        "telemetry_ms": ms(lambda: step._telemetry(
            step._leaf_norms(grads), torch._foreach_mul(params, 1.0))),
        "rng_snapshot_ms": ms(rng_snapshot),
        "host_sample_ms": ms(step.numerics_host_sample),
    }
    turns = {False: [], True: []}
    for armed in (False, True, True, False):
        step.numerics_armed = armed
        turns[armed].append(ms(chunk, max(args.reps // 2, 2)))
    res.update(chunk_ms_not_armed=turns[False], chunk_ms_armed=turns[True],
               order="off, on, on, off",
               armed_added_ms_a_chunk=statistics.mean(turns[True])
               - statistics.mean(turns[False]))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
