"""Serving and training observability on the card (`cuda` marker; skipped
without a GPU), at gpt2-tiny's widths with 2 heads of 64:

- `LLMEngine(economics=True)` on the card's clock: the ledger's phases
  tile its wall clock, the per-tenant and per-class device seconds sum
  to `prefill_compute + decode_compute`, its decode tokens are the
  tokens the decode steps emitted, its positions are what the engine
  dispatched, and the streams equal a disarmed engine's;
- `nonfinite_blame` on a leaf poisoned in 7 elements: the same census as
  the CPU twin's, and the probe launches the flash and LayerNorm kernels
  but not fused Adam;
- `ShardedTrainStep(numerics=True)` in fp32: the telemetry equals the
  CPU twin's within rtol 1e-3 (card and CPU sum in other orders).

No JAX here: on the card's machine run it with `python -m pytest
--noconftest`.
"""
import numpy as np
import pytest
import torch

from _torch_port import require_cuda


def _gpt(device, dtype="bfloat16"):
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return GPTForCausalLM.from_preset("gpt2-tiny", device=device, dtype=dtype,
                                      generator=gen, num_attention_heads=2)


@pytest.mark.cuda
def test_cuda_serving_ledger_tiles_and_apportions():
    require_cuda()
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    model = _gpt("cuda")
    cfg = dict(num_slots=4, block_len=8, n_blocks=8, prefill_chunk=16,
               enable_prefix_cache=False)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32)
               for n in (9, 30, 17, 41, 5, 24)]
    streams = []
    for economics in (False, True):
        eng = LLMEngine(model, LLMEngineConfig(
            **cfg, economics=economics, slo_burn_min_events=2,
            slo_ttft_target_ms={"interactive": 1e-3}))
        hs = [eng.submit(p, max_new_tokens=6,
                         slo=("interactive", "batch")[i % 2],
                         tenant=f"t{i % 3}", trace=economics)
              for i, p in enumerate(prompts)]
        while eng.has_work():
            eng.pump()
        streams.append([h.result(0) for h in hs])
    for a, b in zip(*streams):
        np.testing.assert_array_equal(b, a)
    snap = eng.ledger.snapshot()
    phases = snap["phase_seconds"]
    assert abs(sum(phases.values()) - snap["wall_seconds"]) \
        <= 1e-9 * snap["wall_seconds"]
    compute = phases["prefill_compute"] + phases["decode_compute"]
    assert compute > 0
    for owners in (snap["tenants"], snap["classes"]):
        total = sum(v["device_seconds"] for v in owners.values())
        assert abs(total - compute) <= 1e-9 * compute
    m = eng.metrics.snapshot()
    assert snap["decode_tokens"] == m["tokens_out"]
    assert snap["prefill_tokens"] == eng.prefill_tokens
    assert snap["total_positions"] == eng.steps * 4 * 16
    fired = eng.burn.snapshot()["fired"]
    assert set(fired) == {"interactive"}
    for h in hs:
        mk = h.timeline()["marks_ms"]
        assert mk["submitted"] < mk["admitted"] <= mk["first_token"] \
            <= mk["finished"]


def _twins(dtype):
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainStep
    out = []
    card = _gpt("cuda", dtype)
    cpu = _gpt("cpu", dtype)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    for m, dev in ((card, "cuda"), (cpu, "cpu")):
        m.train()
        opt = AdamW(learning_rate=1e-3, parameters=m.parameters(),
                    weight_decay=0.01)
        out.append(ShardedTrainStep(m, opt, device=dev, numerics=True))
    return out


def _batch(seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 512, (2, 64)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


@pytest.mark.cuda
def test_cuda_blame_census_equals_the_cpu_twin_and_skips_adam():
    require_cuda()
    from paddle_tpu_torch.ops import _kernels
    card, cpu = _twins("bfloat16")
    ids, labels = _batch(2)
    name = "gpt.layers.1.linear1.weight"
    for step in (card, cpu):
        p = dict(step.model.named_parameters())[name]
        with torch.no_grad():
            p.view(-1)[torch.arange(0, 70, 10, device=p.device)] = \
                float("nan")
    _kernels.reset_launch_counts()
    got = card.nonfinite_blame(1, ids, labels)
    torch.cuda.synchronize()
    launches = _kernels.launch_counts()
    want = cpu.nonfinite_blame(1, ids, labels)
    assert got["params"] == want["params"] == {name: 7}
    assert got["grads"] == want["grads"] and got["grads"]
    assert np.isnan(got["loss"])
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "layernorm_fwd",
              "layernorm_bwd"):
        assert launches[k] > 0, (k, launches)
    assert launches["fused_adam"] == 0
    assert all(p.grad is None for p in card.model.parameters())


@pytest.mark.cuda
def test_cuda_telemetry_equals_the_cpu_twin():
    require_cuda()
    card, cpu = _twins("float32")
    for seed in (3, 4):
        ids, labels = _batch(seed)
        card(ids, labels)
        cpu(ids, labels)
    got, want = card.numerics_host_sample(), cpu.numerics_host_sample()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
    assert got["update_ratio/_total"] > 0
