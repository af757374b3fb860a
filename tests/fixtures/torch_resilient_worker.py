"""Subprocess fixture for tests/test_torch_resilient.py: the port's
ResilientTrainer over an AsyncCheckpointManager, on the CPU, training
gpt2-tiny (seed 0) through ScanTrainStep(scan_steps=2) at save_interval
2, max_to_keep 2, so the parent test can kill it in the writer
(PDTPU_FAULTS=kill@N:persist) and resume it in a fresh process.

    python torch_resilient_worker.py WORKDIR NUM_STEPS

Every chunk appends {"start", "losses"} to WORKDIR/losses.jsonl
(fsynced: a SIGKILL loses no line); a clean finish writes
WORKDIR/report.json and the final state to WORKDIR/final.pt. Exit codes:
0 done, -9 (SIGKILL) when a kill clause fires.
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from paddle_tpu_torch.checkpoint import AsyncCheckpointManager  # noqa: E402
from paddle_tpu_torch.distributed.resilient import (  # noqa: E402
    ResilientConfig, ResilientTrainer)
from paddle_tpu_torch.models.gpt import GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.parallel import ScanTrainStep  # noqa: E402

WORKDIR = sys.argv[1]
NUM_STEPS = int(sys.argv[2])
K = 2


def main():
    gen = torch.Generator()
    gen.manual_seed(0)
    model = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu",
                                       generator=gen)
    model.train()
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = ScanTrainStep(model, opt, scan_steps=K, device="cpu")
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 512, (16, 2, 32)).astype(np.int64)
    labels = rng.randint(0, 512, (16, 2, 32)).astype(np.int64)
    losses = open(os.path.join(WORKDIR, "losses.jsonl"), "a")

    class Recorded:
        scan_steps = K
        device = step.device
        start = None

        def __call__(self, *args):
            out = step(*args)
            losses.write(json.dumps({"start": self.start,
                                     "losses": out.tolist()}) + "\n")
            losses.flush()
            os.fsync(losses.fileno())
            return out

    fn = Recorded()

    def batch_fn(i):
        fn.start = i
        return ids[i:i + K], labels[i:i + K]

    def get_state():
        return {"model": model.state_dict(), "opt": opt.state_dict(),
                "step": step._step_count}

    def set_state(s):
        model.set_state_dict(s["model"])
        opt.set_state_dict(s["opt"])
        step._step_count = int(s["step"])

    ckpt = AsyncCheckpointManager(os.path.join(WORKDIR, "ckpt"),
                                  max_to_keep=2, device="cpu")
    trainer = ResilientTrainer(fn, ckpt, get_state=get_state,
                               set_state=set_state,
                               config=ResilientConfig(save_interval=2))
    summary = trainer.run(batch_fn, num_steps=NUM_STEPS)
    ckpt.close()
    torch.save(get_state(), os.path.join(WORKDIR, "final.pt"))
    resumed = [e["step"] for e in summary["events"]
               if e["kind"] == "resumed"]
    with open(os.path.join(WORKDIR, "report.json"), "w") as f:
        json.dump({"resumed_from": resumed[0] if resumed else 0,
                   "completed": summary["completed_steps"],
                   "events": [e["kind"] for e in summary["events"]]}, f)


if __name__ == "__main__":
    main()
