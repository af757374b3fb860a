"""The serving front end on the card (`cuda` marker; skipped without a
GPU). No JAX here: on the card's machine run it with `python -m pytest
--noconftest`.

gpt3-1.3b's widths cut to 2 layers, bf16, engines of one geometry (every
unified step [4, 16]), on SimClocks.
- `replace_params` rebinds the model to the new tensors and leaves the
  prior ones bit-equal; streams on the new weights equal a plain engine's
  on them, and passing the prior dict back restores the prior streams bit
  for bit.
- A failover re-prefill (`replica_crash` mid-decode) gives every stream
  of an uninterrupted fleet bit for bit on the card.
- A prefill-to-decode handoff between two engines on one device gives
  every stream of a solo engine bit for bit, every stream handed off.
"""
import copy

import numpy as np
import pytest
import torch

from _torch_port import require_cuda

CFG = dict(num_slots=4, block_len=8, n_blocks=16, prefill_chunk=16,
           max_new_tokens=16, enable_prefix_cache=False)


def _model(seed):
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return GPTForCausalLM.from_preset("gpt3-1.3b", dtype="bfloat16",
                                      generator=gen, num_hidden_layers=2)


def _prompts():
    rng = np.random.RandomState(1)
    return [rng.randint(0, 50304, (n,)).astype(np.int32)
            for n in (5, 30, 17, 64, 9, 41)]


def _engine(model, clock=None):
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    return LLMEngine(model, LLMEngineConfig(**CFG),
                     clock=clock or SimClock())


def _drain(eng, prompts):
    hs = [eng.submit(p) for p in prompts]
    while eng.has_work():
        eng.pump()
    return [h.result(0) for h in hs]


def _fleet(models, roles=None, plan=None):
    from paddle_tpu_torch import serving
    clock = serving.SimClock()
    roles = roles or ["mixed"] * len(models)
    return serving.ReplicaRouter([
        serving.InProcessReplica(_engine(m, clock), i, fault_plan=plan,
                                 role=roles[i])
        for i, m in enumerate(models)])


def _drive(router):
    steps = 0
    while router.has_work():
        router.clock.advance(0.01)
        router.pump()
        steps += 1
        assert steps < 4000


@pytest.mark.cuda
def test_cuda_replace_params_rebinds_and_rollback_is_bit_equal():
    require_cuda()
    model, other = _model(0), _model(5)
    prompts = _prompts()
    eng = _engine(model)
    before = _drain(eng, prompts)
    prior = {k: (v, v.clone()) for k, v in eng.params.items()}
    new = {k: v.clone() for k, v in other.state_dict().items()}
    eng.replace_params(new, "v2")
    assert eng.weight_version == "v2"
    assert all(eng.params[k].data_ptr() == v.data_ptr()
               for k, v in new.items())
    assert all(torch.equal(t, c) for t, c in prior.values())
    on_v2 = _drain(eng, prompts)
    for a, b in zip(on_v2, _drain(_engine(other), prompts)):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(on_v2, before))
    eng.replace_params({k: t for k, (t, _) in prior.items()}, "v0")
    assert all(eng.params[k].data_ptr() == t.data_ptr()
               for k, (t, _) in prior.items())
    for a, b in zip(_drain(eng, prompts), before):
        np.testing.assert_array_equal(a, b)
    assert eng.pool.check_balance()


@pytest.mark.cuda
def test_cuda_failover_reprefill_equals_the_uninterrupted_fleet():
    require_cuda()
    from paddle_tpu_torch.utils.fault_injection import FaultPlan
    model = _model(0)
    prompts = _prompts()
    ref_fleet = _fleet([model, copy.deepcopy(model)])
    ref = [ref_fleet.submit(p) for p in prompts]
    _drive(ref_fleet)
    plan = FaultPlan()
    router = _fleet([model, copy.deepcopy(model)], plan=plan)
    hs = [router.submit(p) for p in prompts]
    for _ in range(8):
        router.clock.advance(0.01)
        router.pump()
    victims = [h for h in hs if h._replica is router.replicas[0]]
    assert victims and all(h.tokens_so_far() for h in victims)
    plan.add("replica_crash", 0)
    _drive(router)
    for h, r in zip(hs, ref):
        np.testing.assert_array_equal(h.result(0), r.result(0))
    assert sum(h.failovers for h in hs) == len(victims)
    assert router.healthz()["replicas"]["replica0"] == "quarantined"


@pytest.mark.cuda
def test_cuda_handoff_between_engines_is_bit_equal():
    require_cuda()
    model = _model(0)
    prompts = _prompts()
    solo = _drain(_engine(model), prompts)
    router = _fleet([model, copy.deepcopy(model)],
                    roles=["prefill", "decode"])
    hs = [router.submit(p) for p in prompts]
    _drive(router)
    for h, r in zip(hs, solo):
        np.testing.assert_array_equal(h.result(0), r)
    snap = router.metrics.snapshot()
    assert snap["handoffs"] == len(prompts) and snap["handoffs_failed"] == 0
    assert router.replicas[1].engine.kv_import_tokens == \
        sum(len(p) for p in prompts)
    for r in router.replicas:
        assert r.engine.pool.check_balance()
