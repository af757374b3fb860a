"""LoRA in the PyTorch port against the JAX package: the gathered delta
(`ops/lora.py`), injection and the adapter tree (`tuning/lora.py`), the
bridge across an injected model, the serving `AdapterBank`
(`serving/llm/lora.py`) and the decode-FLOPs helper (`obs/flops.py`).

- Ops: `lora_delta` / `lora_matmul` within 1e-5 of JAX's in fp32 (the
  same products, summed in another order); a row on bank row 0 gives an
  exact-zero delta, so `add_lora_delta` leaves its y bit-equal, bf16
  included.
- Injection on gpt2-tiny and llama2-tiny: after `inject_lora` on both
  sides and the JAX model's state bridged in (its `functional_state()`
  split: adapter leaves as params, the frozen base as buffers), the
  trainable names are the JAX params' keys; the training loss equals
  JAX's within 1e-5 before and after 3 SGD steps through both packages'
  `ScanTrainStep` (the adapter leaves within 1e-5 too), every base
  weight stays bit-equal on both sides, and `adapter_state_dict`,
  `adapter_signature` and `merge_adapter_delta` match JAX's (merged
  weights within 1e-6).
- `AdapterBank`: the same load / hot swap / bind / snapshot / unload /
  restore sequence as JAX's gives equal rows (bit-equal: both store the
  fp32 trees), equal `snapshot()`s and the same typed reasons; a
  mutation never writes a tensor already handed out (copy-on-write).
"""
import numpy as np
import pytest
import torch

from _torch_port import adapter_tree, one_torch_thread  # noqa: F401
from _torch_port import tiny_models, train_batches

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5


def _delta_inputs(seed=0, Bn=3, T=5, din=16, dout=24, K=4, r=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(Bn, T, din).astype(np.float32)
    A = rng.randn(K, r, din).astype(np.float32)
    B = rng.randn(K, dout, r).astype(np.float32)
    A[0], B[0] = 0.0, 0.0                 # the bank's base row
    idx = np.array([0, 2, 3], np.int32)
    scale = np.array([0.0, 0.5, 2.0, 4.0], np.float32)
    return x, A, B, idx, scale


def test_lora_ops_match_jax():
    import jax.numpy as jnp
    from paddle_tpu.ops import lora as jl
    from paddle_tpu_torch.ops import lora as tl
    x, A, B, idx, scale = _delta_inputs()
    want = np.asarray(jl.lora_delta(*map(jnp.asarray, (x, A, B, idx,
                                                       scale))))
    got = tl.lora_delta(*map(torch.from_numpy, (x, A, B, idx, scale)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert not got[0].any() and got[1].abs().max() > 0
    want = np.asarray(jl.lora_matmul(jnp.asarray(x), jnp.asarray(A[2]),
                                     jnp.asarray(B[2])))
    got = tl.lora_matmul(torch.from_numpy(x), torch.from_numpy(A[2]),
                         torch.from_numpy(B[2]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_add_lora_delta_row_zero_is_bit_exact():
    from paddle_tpu_torch.ops.lora import add_lora_delta
    x, A, B, idx, scale = _delta_inputs(1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y = torch.randn(3, 5, 24, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    out = add_lora_delta(y, xb, (torch.from_numpy(A), torch.from_numpy(B)),
                         torch.from_numpy(idx), torch.from_numpy(scale))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out[0], y[0]) and not torch.equal(out[1], y[1])
    assert add_lora_delta(y, xb, None, None, None) is y


def _injected_pair(preset, rank=4, alpha=8.0, seed=3):
    """(JAX model, port model), both injected, the port carrying the JAX
    model's weights and adapter leaves (non-zero B, from adapter_tree)."""
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTForCausalLM as JG
    from paddle_tpu.models.llama import LlamaForCausalLM as JL
    from paddle_tpu.tuning import LoRAConfig as JCfg
    from paddle_tpu.tuning import inject_lora as jinject
    from paddle_tpu.tuning import load_adapter_state as jload
    from paddle_tpu_torch.bridge import load_jax_state
    from paddle_tpu_torch.models.gpt import GPTForCausalLM as TG
    from paddle_tpu_torch.models.llama import LlamaForCausalLM as TL
    from paddle_tpu_torch.tuning import LoRAConfig, inject_lora
    Jax, Port = (JL, TL) if preset.startswith("llama") else (JG, TG)
    paddle.seed(0)
    jm = Jax.from_preset(preset)
    jinject(jm, JCfg(rank=rank, alpha=alpha))
    jload(jm, adapter_tree(jm, seed, rank=rank, sigma=0.05))
    tm = Port.from_preset(preset, device="cpu")
    inject_lora(tm, LoRAConfig(rank=rank, alpha=alpha))
    params, buffers = jm.functional_state()
    load_jax_state(tm, {k: np.asarray(v) for k, v in params.items()},
                   {k: np.asarray(v) for k, v in buffers.items()})
    return jm, tm


@pytest.mark.parametrize("preset", ["gpt2-tiny", "llama2-tiny"])
def test_injected_training_matches_jax_and_freezes_the_base(preset):
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.parallel import ScanTrainStep as JaxScan
    from paddle_tpu.tuning import lora_parameters as jlora_params
    from paddle_tpu_torch.bridge import export_functional_state
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.parallel import ScanTrainStep
    from paddle_tpu_torch.tuning import lora_parameters
    from _torch_port import one_cpu_mesh
    jm, tm = _injected_pair(preset)
    jparams, jbufs = jm.functional_state()
    tparams, tbufs = export_functional_state(tm)
    assert sorted(tparams) == sorted(jparams)
    assert all("lora_" in k for k in tparams)
    assert set(tbufs) == set(jbufs)
    assert len(lora_parameters(tm)) == len(tparams)
    base0 = {k: p.detach().clone() for k, p in tm.named_parameters()
             if not p.requires_grad}
    ids, labels = (np.repeat(a[:1], 3, axis=0)      # one batch, 3 steps
                   for a in train_batches(0, K=1, B=2, S=32))
    tm.train()
    with torch.no_grad():
        l0 = tm(torch.from_numpy(ids[0]), labels=torch.from_numpy(
            labels[0]).long())
    jstep = JaxScan(jm, jopt.SGD(learning_rate=0.1,
                                 parameters=jlora_params(jm)),
                    one_cpu_mesh(), scan_steps=3, zero_stage=0,
                    donate=False)
    want = np.asarray(jstep(ids, labels).data)
    step = ScanTrainStep(tm, SGD(learning_rate=0.1,
                                 parameters=lora_parameters(tm)),
                         scan_steps=3, device="cpu")
    got = step(ids, labels).numpy()
    np.testing.assert_allclose(float(l0), want[0], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert got[-1] < got[0]
    named = dict(tm.named_parameters())
    for k, v in jstep._params.items():
        np.testing.assert_allclose(named[k].detach().numpy(),
                                   np.asarray(v), atol=TOL, rtol=0)
    for k, t in base0.items():
        assert torch.equal(named[k], t), k
    with torch.no_grad():
        l3 = tm(torch.from_numpy(ids[0]), labels=torch.from_numpy(
            labels[0]).long())
    assert float(l3) < float(l0)


def test_adapter_tree_signature_and_merge_match_jax():
    from paddle_tpu.tuning import adapter_signature as jsig
    from paddle_tpu.tuning import adapter_state_dict as jtree
    from paddle_tpu.tuning import merge_adapter_delta as jmerge
    from paddle_tpu.tuning import target_sites as jsites
    from paddle_tpu_torch.bridge import export_state
    from paddle_tpu_torch.tuning import (adapter_signature,
                                         adapter_state_dict,
                                         default_lora_targets,
                                         load_adapter_state,
                                         merge_adapter_delta, target_sites)
    jm, tm = _injected_pair("gpt2-tiny", seed=5)
    assert target_sites(tm) == jsites(jm)
    assert default_lora_targets(tm) == ("qkv_proj", "out_proj", "linear1",
                                        "linear2")
    for args in ((4,), (4, 8.0), (2, None, ("qkv_proj", "linear2"))):
        assert adapter_signature(tm, *args) == jsig(jm, *args)
    want, got = jtree(jm), adapter_state_dict(tm)
    assert want.keys() == got.keys()
    for li in want:
        assert want[li].keys() == got[li].keys()
        for site in want[li]:
            for f in ("A", "B"):
                np.testing.assert_array_equal(got[li][site][f],
                                              want[li][site][f])
    # a round trip through the tree is bit-exact and keeps the storage
    A = tm.gpt.layers[0].self_attn.qkv_proj.lora_A
    ptr = A.data_ptr()
    load_adapter_state(tm, adapter_tree(tm, 9, sigma=0.05))
    load_adapter_state(tm, got)
    assert A.data_ptr() == ptr
    np.testing.assert_array_equal(adapter_state_dict(tm)["1"]["linear1"]["B"],
                                  got["1"]["linear1"]["B"])
    with pytest.raises(ValueError, match="shape mismatch"):
        load_adapter_state(tm, adapter_tree(tm, 1, rank=2))
    jmerge(jm)
    merge_adapter_delta(tm)
    mine = export_state(tm)
    for k, v in jm.functional_state()[1].items():
        if ".base." in k:
            np.testing.assert_allclose(mine[k], np.asarray(v), atol=1e-6,
                                       rtol=0)
    assert not tm.gpt.layers[1].linear2.lora_B.any()


def test_inject_lora_refuses_twice_and_bad_configs():
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.tuning import (LoRAConfig, adapter_state_dict,
                                         inject_lora)
    with pytest.raises(ValueError, match="rank"):
        LoRAConfig(rank=0)
    with pytest.raises(ValueError, match="alpha"):
        LoRAConfig(alpha=0)
    tm = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu")
    with pytest.raises(ValueError, match="no injected"):
        adapter_state_dict(tm)
    inject_lora(tm, LoRAConfig(rank=2, targets=("out_proj",)))
    with pytest.raises(ValueError, match="already injected"):
        inject_lora(tm, LoRAConfig(rank=2, targets=("out_proj",)))
    assert set(adapter_state_dict(tm)["0"]) == {"out_proj"}


def _bank_script(mod, model, trees):
    """One lifecycle on a bank of `mod` (either package's serving.llm.lora):
    (readings after each step, typed reasons)."""
    bank = mod.AdapterBank(model, max_adapters=2, rank=4, num_slots=3,
                           default_alpha=8.0)
    out, reasons = [], []

    def rows():
        layers, _, _ = bank.args_for_rows([0, 1, 2])
        return {f"{i}.{s}.{k}": np.array(ab[j], np.float32)
                for i, layer in enumerate(layers)
                for s, ab in layer.items() for j, k in ((0, "A"), (1, "B"))}

    def expect(reason, fn, *a):
        with pytest.raises(mod.AdapterError) as e:
            fn(*a)
        reasons.append(e.value.reason)

    out.append((bank.load("a", trees[0]), bank.snapshot()))
    out.append((bank.load("b", trees[1], alpha=2.0), bank.snapshot()))
    expect("bank_full", bank.load, "c", trees[2])
    expect("rank_mismatch", bank.validate_tree, trees[0], 8)
    expect("layers_mismatch", bank.load, "c", {"0": trees[0]["0"]})
    bad = {li: {s: e for s, e in layer.items() if s != "linear1"}
           for li, layer in trees[0].items()}
    expect("targets_mismatch", bank.load, "c", bad)
    expect("unknown_adapter", bank.bind_slot, 0, "nope")
    out.append((bank.bind_slot(1, "b"), bank.bind_slot(2, None),
                [bank.slot_row(s) for s in range(3)]))
    snap = bank.snapshot_row("a")
    out.append((bank.load("a", trees[2], alpha=16.0), bank.snapshot(),
                rows()))
    bank.restore("a", snap)
    out.append((bank.snapshot(), rows(), bank.adapter_of_row(1),
                bank.row_of("b")))
    bank.unload("b")
    expect("unknown_adapter", bank.unload, "b")
    bank.restore("a", None)
    bank.clear_slot(1)
    out.append((bank.snapshot(), rows(), bank.snapshot_row("a"),
                [bank.slot_row(s) for s in range(3)],
                float(np.asarray(bank.args_for_rows([0])[2]).sum())))
    return out, reasons, bank


def test_adapter_bank_matches_jax():
    from paddle_tpu.serving.llm import lora as jlora
    from paddle_tpu_torch.serving.llm import lora as tlora
    jm, tm = tiny_models()
    trees = [adapter_tree(tm, s) for s in (1, 2, 3)]
    want, wreasons, jbank = _bank_script(jlora, jm, trees)
    got, greasons, bank = _bank_script(tlora, tm, trees)
    assert greasons == wreasons == ["bank_full", "rank_mismatch",
                                    "layers_mismatch", "targets_mismatch",
                                    "unknown_adapter", "unknown_adapter"]
    assert bank.signature == jbank.signature
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, dict) and a and isinstance(
                    next(iter(a.values())), np.ndarray):
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a == b


def test_adapter_bank_writes_copy_on_write():
    """A step's operand, taken before a swap or an unload, keeps its
    values: the bank never writes a tensor it has handed out."""
    from paddle_tpu_torch.serving.llm.lora import AdapterBank
    _, tm = tiny_models()
    bank = AdapterBank(tm, max_adapters=2, rank=4, num_slots=2)
    bank.load("a", adapter_tree(tm, 1))
    bank.bind_slot(0, "a")
    layers, idx, scale = bank.device_args()
    before = [{s: (a.clone(), b.clone()) for s, (a, b) in layer.items()}
              for layer in layers]
    idx0, scale0 = idx.clone(), scale.clone()
    bank.load("a", adapter_tree(tm, 2), alpha=1.0)
    bank.clear_slot(0)
    new_layers, new_idx, _ = bank.device_args()
    assert not torch.equal(new_layers[0]["qkv_proj"][0],
                           before[0]["qkv_proj"][0])
    bank.unload("a")
    for layer, old in zip(layers, before):
        for s, (a, b) in layer.items():
            assert torch.equal(a, old[s][0]) and torch.equal(b, old[s][1])
    assert torch.equal(idx, idx0) and torch.equal(scale, scale0)
    assert int(new_idx[0]) == 0


def test_lora_decode_flops_helper_matches_jax():
    from paddle_tpu.obs.flops import lora_decode_flops_per_token as jf
    from paddle_tpu_torch.obs import lora_decode_flops_per_token as tf
    dims = [(4, 4), (4, 8)]
    assert tf(8, dims) == jf(8, dims) == 2 * 8 * 8 + 2 * 8 * 12
    assert tf(1, []) == jf(1, []) == 0.0
    sites = [(2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048)] * 24
    assert tf(8, sites) == jf(8, sites) == 2 * 8 * 32768 * 24
