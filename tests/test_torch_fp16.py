"""fp16 end to end in the PyTorch port against the JAX package, on the CPU.

- Paddle's pure-fp16 (O2) recipe: `amp.decorate(model, level="O2",
  dtype="float16")` (every parameter fp16), `AdamW(multi_precision=True)`
  (fp32 master weights) and the strategy step in fp16 (dynamic loss
  scaling from a first step forced to overflow, gradient merge k = 2;
  recompute under AMP is tests/test_torch_plan_step.py's), at gpt2-tiny,
  against the JAX step built from the JAX compiler's plan as
  tests/test_torch_plan_step.py builds it. After every chunk the loss
  scale, its good and bad counters and the merge count are EXACTLY equal;
  losses within 2.5e-4 (the strategy tests' fp16 limit: the packages
  round a GELU, a bias add or a product's output to fp16 at other
  places); the fp16 parameters under `_assert_amp_weights`' rule (every
  element within 2 x lr x steps, at most 1% of them more than lr / 2
  apart), and so the fp32 master weights, read out of the port through
  `bridge.export_optimizer_state` and carried from JAX into a fresh port
  optimizer through `bridge.load_jax_optimizer_state` (bit for bit).
- An fp16 `LLMEngine` (the model cast with `.to(dtype=float16)`) against
  the JAX engine over the same cast model, prefill chunking on. Both
  sides' logits are fp16, rounded from fp32 sums taken in another order,
  and part by up to one fp16 ulp (2^-9 for this model's |logit| < 4): the
  logprobs are held within 2^-8 (an ulp each in the chosen logit and in
  the log-sum-exp), and the streams are equal up to a near-tie. Where two
  streams first differ, the port's logits for that step (a one-shot
  prefill of the prompt and the stream so far, which the port engine's
  step equals bit for bit on the CPU) must pick the port's token and rank
  the JAX engine's within two fp16 ulps of it: each side's logit differs
  from the other's by an ulp at most, so rounding alone decided; past
  that the contexts differ and the streams are not compared. The
  untrained model's logits are nearly flat, so such ties do occur. The
  prefill and decode counts, prefix metrics, pool stats and both ledgers
  are equal as `assert_engines_equal` holds them.

(On the card, chip_smoke.py's `train_fp16_o2` and `serve_fp16` run the
same paths at full gpt3-1.3b width through the fp16 kernels.)
"""
import numpy as np
import pytest
import torch

from _torch_port import (PREFIX_KEYS, drain, engine_pair,  # noqa: F401
                         one_torch_thread, train_batches, train_models)
from test_torch_plan_step import (LR, _assert_amp_weights, _jax_step,
                                  _scalars, _strategies)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

O2_FIELDS = {"amp": True, "amp_configs": {
    "dtype": "float16", "init_loss_scaling": 2.0 ** 40,
    "decr_every_n_nan_or_inf": 1, "decr_ratio": 2.0 ** -25,
    "incr_every_n_steps": 2}, "gradient_merge": True,
    "gradient_merge_configs": {"k_steps": 2}}
O2_K, O2_CHUNKS = 2, 3


def _o2_optimizers(jm, tm):
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    return (jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                       weight_decay=0.01, multi_precision=True,
                       grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0)),
            topt.AdamW(learning_rate=LR, parameters=tm.parameters(),
                       weight_decay=0.01, multi_precision=True,
                       grad_clip=ClipGradByGlobalNorm(1.0)))


def test_o2_fp16_strategy_step_matches_jax():
    import paddle_tpu as paddle
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.bridge import (export_optimizer_state,
                                         load_jax_optimizer_state,
                                         load_jax_state)
    from paddle_tpu_torch.parallel import parallelize
    jm, tm = train_models()
    paddle.amp.decorate(jm, level="O2", dtype="float16")
    amp.decorate(tm, level="O2", dtype="float16")
    assert {p.dtype for p in tm.parameters()} == {torch.float16}
    jo, to = _o2_optimizers(jm, tm)
    js, ts = _strategies(O2_FIELDS, O2_K)
    jstep = _jax_step(jm, jo, js)
    step = parallelize(tm, to, strategy=ts, device="cpu")
    ids, labels = train_batches(0, K=O2_K * O2_CHUNKS)
    trajectory = []
    for c in range(O2_CHUNKS):
        sl = slice(c * O2_K, (c + 1) * O2_K)
        want = np.asarray(jstep(ids[sl], labels[sl]).data)
        got = step(ids[sl], labels[sl]).numpy()
        np.testing.assert_allclose(got, want, atol=2.5e-4, rtol=0)
        jx, tx = _scalars(jstep._extras), _scalars(step._extras)
        assert tx == jx, (c, tx, jx)
        trajectory.append(tx["loss_scale"])
    # the first micro-step overflows fp16 (2^40 scale): 2^15, then growth
    # after two finite micro-steps
    assert trajectory[0] == 2.0 ** 15 and trajectory[-1] > 2.0 ** 15
    steps = O2_K * O2_CHUNKS
    assert step._step_count == jstep._step_count == steps
    assert {p.dtype for p in tm.parameters()} == {torch.float16}
    _assert_amp_weights(jstep._params, tm, steps)
    # the fp32 master weights: the port's, read out, under the same rule;
    # JAX's, carried into a fresh port optimizer over a fresh port model
    # that took JAX's fp16 parameters, come back bit for bit
    jmaster = {k: np.asarray(s["master_weight"], np.float32)
               for k, s in jstep._opt_state.items()}
    mine = export_optimizer_state(to, tm)
    assert set(mine) == set(jmaster)
    for k, v in mine.items():
        assert v["master_weight"].dtype == np.float32
        d = np.abs(v["master_weight"] - jmaster[k])
        assert d.max() <= 2 * LR * steps, (k, float(d.max()))
    far = sum(int((np.abs(mine[k]["master_weight"] - jmaster[k]) > LR / 2)
                  .sum()) for k in mine)
    assert far <= 0.01 * sum(v.size for v in jmaster.values())
    _, fresh = train_models()
    amp.decorate(fresh, level="O2", dtype="float16")
    load_jax_state(fresh, {k: np.asarray(v) for k, v in
                           jstep._params.items()})
    opt = _o2_optimizers(jm, fresh)[1]
    load_jax_optimizer_state(opt, fresh, {
        k: {s: np.asarray(a) for s, a in slots.items()}
        for k, slots in jstep._opt_state.items()})
    back = export_optimizer_state(opt, fresh)
    for k, slots in jstep._opt_state.items():
        for s, a in slots.items():
            np.testing.assert_array_equal(back[k][s],
                                          np.asarray(a, np.float32))


def test_fp16_engine_matches_jax_engine():
    jm, tm = train_models()
    tm.eval()
    jm.to(dtype="float16")
    tm.to(dtype=torch.float16)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32)
               for n in (40, 9, 23)]
    je, te = engine_pair(jm, tm, dict(num_slots=2, block_len=8, n_blocks=8,
                                      prefill_chunk=16))
    assert te.pool.slabs[0][0].dtype == torch.float16
    jh = [je.submit(p, max_new_tokens=6, logprobs=True) for p in prompts]
    th = [te.submit(p, max_new_tokens=6, logprobs=True) for p in prompts]
    drain(je)
    drain(te)
    assert te.prefill_tokens == sum(len(p) for p in prompts)
    for prompt, a, b in zip(prompts, jh, th):
        jt = np.asarray(a.tokens_so_far())
        tt = np.asarray(b.tokens_so_far())
        assert len(jt) == len(tt) == 6 and a.future.done() and b.future.done()
        same = int(np.argmax(np.append(jt != tt, True)))
        np.testing.assert_allclose(b.logprobs_so_far()[:same + 1],
                                   a.logprobs_so_far()[:same + 1],
                                   atol=2.0 ** -8, rtol=0)
        if same < len(jt):
            # the port engine's step equals a one-shot prefill of the same
            # context bit for bit; the JAX logits of it are within an ulp
            # of these, so the JAX choice can beat the port's by at most
            # two ulps here
            ctx = torch.from_numpy(np.concatenate([prompt, jt[:same]])[None])
            with torch.no_grad():
                lg, _ = tm.forward_with_cache(ctx, tm.init_cache(1, 64), 0)
            lg = lg.float().numpy()[0, -1]
            gap = float(lg[tt[same]] - lg[jt[same]])
            ulp = 2.0 ** (np.floor(np.log2(np.abs(lg).max())) - 10)
            assert lg.argmax() == tt[same] and gap <= 2 * ulp, \
                (same, jt, tt, gap, ulp)
    for attr in ("prefill_tokens", "decode_iterations"):
        assert getattr(te, attr) == getattr(je, attr), attr
    js, ts = je.metrics.snapshot(), te.metrics.snapshot()
    for k in PREFIX_KEYS:
        assert ts[k] == js[k], (k, js[k], ts[k])
    assert te.pool.stats == je.pool.stats
    assert te.pool.check_balance() and je.pool.check_balance()
