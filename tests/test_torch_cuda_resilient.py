"""Checkpoint snapshots and ring rollbacks on the card (`cuda` marker;
skipped without a GPU). The port's train step updates parameters and
Adam's slots in place through the fused-Adam kernel, so:

- a snapshot is an owned host copy, finished before the next step's first
  launch: a following step leaves it bit-unchanged (and the step did move
  the live tensors);
- a rollback from the ring writes into the live storage (every
  parameter's and slot's `data_ptr` is kept), and the step taken from it
  equals, bit for bit, the step taken from the state before.

gpt2-tiny's widths with 2 heads of 64 in bf16, fp32 moments, through
ScanTrainStep(scan_steps=2): the flash, LayerNorm and fused-Adam kernels.
No JAX here: on the card's machine run it with `python -m pytest
--noconftest`.
"""
import numpy as np
import pytest
import torch

from _torch_port import require_cuda


def _cell():
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ScanTrainStep
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    model = GPTForCausalLM.from_preset("gpt2-tiny", dtype="bfloat16",
                                       generator=gen, num_attention_heads=2)
    model.train()
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = ScanTrainStep(model, opt, scan_steps=2)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 512, (3, 2, 2, 64))
                           .astype(np.int32)).cuda()

    def get_state():
        return {"model": model.state_dict(), "opt": opt.state_dict(),
                "step": step._step_count}

    def set_state(s):
        model.set_state_dict(s["model"])
        opt.set_state_dict(s["opt"])
        step._step_count = int(s["step"])

    def ptrs():
        return [p.data_ptr() for p in model.parameters()] + [
            t.data_ptr() for slots in opt.state.values()
            for t in slots.values()]

    return step, ids, get_state, set_state, ptrs


def _tensors(state):
    from paddle_tpu_torch.checkpoint import _keystr, _leaves_with_path
    return {_keystr(p): t for p, t in _leaves_with_path(state)
            if torch.is_tensor(t)}


@pytest.mark.cuda
def test_cuda_snapshot_is_unchanged_by_the_next_fused_adam_step(tmp_path):
    require_cuda()
    from paddle_tpu_torch.checkpoint import AsyncCheckpointManager
    from paddle_tpu_torch.ops import _kernels
    step, ids, get_state, _, _ = _cell()
    step(ids[0], ids[0])                 # the slots exist from here
    ckpt = AsyncCheckpointManager(str(tmp_path), max_to_keep=2)
    want = {k: t.clone() for k, t in _tensors(get_state()).items()}
    snap = ckpt.snapshot(2, get_state())
    _kernels.reset_launch_counts()
    step(ids[1], ids[1])                 # updates in place, right away
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["fused_adam"] > 0
    live = _tensors(get_state())
    host = _tensors(snap.state)
    assert set(host) == set(want)
    moved = 0
    for k, w in want.items():
        assert host[k].device.type == "cpu"
        assert torch.equal(host[k], w.cpu()), k
        moved += not torch.equal(live[k], w)
    assert moved > len(want) // 2        # the step did change the state
    ckpt.wait_until_finished()
    disk = _tensors(ckpt.restore(2))
    for k, w in want.items():
        assert disk[k].is_cuda and torch.equal(disk[k], w), k
    ckpt.close()


@pytest.mark.cuda
def test_cuda_ring_rollback_keeps_storage_and_replays_bit_equal(tmp_path):
    require_cuda()
    from paddle_tpu_torch.checkpoint import AsyncCheckpointManager
    step, ids, get_state, set_state, ptrs = _cell()
    step(ids[0], ids[0])
    ckpt = AsyncCheckpointManager(str(tmp_path), max_to_keep=2)
    snap = ckpt.snapshot(2, get_state())
    first = step(ids[1], ids[1]).cpu()
    after_first = {k: t.clone() for k, t in _tensors(get_state()).items()}
    step(ids[2], ids[2])                 # wander off
    before = ptrs()
    set_state(ckpt.ring_state(snap))
    assert ptrs() == before
    again = step(ids[1], ids[1]).cpu()
    assert torch.equal(again, first)
    now = _tensors(get_state())
    for k, w in after_first.items():
        assert torch.equal(now[k], w), k
    ckpt.close()
