"""The cached forward with `adapters=` of the port's GPT and Llama against
the JAX models', on the serving step's form (slab rows, per-row
positions, block tables, ragged lengths) with a mixed batch: a base row
(bank row 0), two rows on different adapters, and a free row.

The logits of every real column agree within CACHE_ATOL (1e-4, fp32:
the same products summed in another order, as in the unadapted cases of
tests/test_torch_gpt.py and tests/test_torch_llama.py); the base row's
logits are bit-equal to the port's unadapted forward (an exact-zero
delta), and each adapted row differs from it.
"""
import numpy as np
import pytest
import torch

from _torch_port import (CACHE_ATOL, adapter_tree, jax_caches,  # noqa: F401
                         jax_prefill, one_torch_thread, tiny_models)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _banks(jm, tm, rank=4):
    """Both packages' banks with the same two adapters (rows 1, 2), and
    the per-row bank rows of the batch."""
    from paddle_tpu.serving.llm.lora import AdapterBank as JaxBank
    from paddle_tpu_torch.serving.llm.lora import AdapterBank
    jb = JaxBank(jm, max_adapters=2, rank=rank, num_slots=4)
    tb = AdapterBank(tm, max_adapters=2, rank=rank, num_slots=4)
    for aid, seed, alpha in (("a", 1, None), ("b", 2, 3.0)):
        tree = adapter_tree(tm, seed, rank=rank)
        jb.load(aid, tree, alpha=alpha)
        tb.load(aid, tree, alpha=alpha)
    rows = np.array([0, 1, 2, 0], np.int32)
    return jb.args_for_rows(rows), tb.args_for_rows(rows)


@pytest.mark.parametrize("preset", ["gpt2-tiny", "llama2-tiny"])
def test_adapted_cached_forward_matches_jax(preset):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.models.generation import make_decoder_fns
    jm, tm = tiny_models(preset)
    jad, tad = _banks(jm, tm)
    rng = np.random.RandomState(3)
    N, bl, nb, C = 4, 8, 4, 6
    L = nb * bl + C
    toks = rng.randint(0, 512, (N, C)).astype(np.int32)
    pos = np.array([0, 3, 5, nb * bl], np.int32)       # last: a free row
    adv = np.array([6, 2, 4, 0], np.int32)
    table = (np.arange(N, dtype=np.int32)[:, None] * nb
             + np.arange(nb, dtype=np.int32)[None])
    seq = (pos + adv).astype(np.int32)
    params, prefill, _ = make_decoder_fns(jm)
    # one jit: eager JAX would compile op by op
    ref, _ = jax.jit(lambda p, t, c, ps, tb, sq, ad: prefill(
        p, t, c, ps, paged=(tb, sq, bl, nb), adapters=ad))(
        params, jnp.asarray(toks), jax_caches(jm, N, L), jnp.asarray(pos),
        jnp.asarray(table), jnp.asarray(seq), jad)
    ref = np.asarray(ref)
    tpaged = (torch.from_numpy(table), torch.from_numpy(seq), bl, nb)
    out, _ = tm.forward_with_cache(torch.from_numpy(toks), tm.init_cache(N, L),
                                   torch.from_numpy(pos), paged=tpaged,
                                   adapters=tad)
    plain, _ = tm.forward_with_cache(torch.from_numpy(toks),
                                     tm.init_cache(N, L),
                                     torch.from_numpy(pos), paged=tpaged)
    for r in range(N - 1):      # real columns only; the rest are discarded
        n = int(adv[r])
        np.testing.assert_allclose(out.numpy()[r, :n], ref[r, :n],
                                   atol=CACHE_ATOL, rtol=0)
    assert torch.equal(out[0], plain[0])
    for r in (1, 2):
        assert (out[r, :adv[r]] - plain[r, :adv[r]]).abs().max() > 1e-3
