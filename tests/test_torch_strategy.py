"""`DistributedStrategy` and `StrategyCompiler` in the PyTorch port against
the JAX package's, field for field.

- Every public field of the JAX strategy and of each of its config
  dataclasses is in the port's, with the same default; `to_dict` equals
  the JAX one after the same assignments (dict assignment into
  `*_configs` included); the prototxt round trip restores it.
- The compiler's field buckets, `TRANSFORM_ORDER` and, over a matrix of
  strategies, every plan field, the `applied` order and the conflict
  warnings (text for text) equal the JAX compiler's; the LARS and LAMB
  swaps build the same optimizer with the same settings.
"""
import dataclasses
import warnings

import numpy as np
import pytest


def _public(obj):
    return {k: v for k, v in vars(obj).items() if not k.startswith("_")}


def test_field_audit_matches_jax():
    from paddle_tpu.distributed import strategy as js
    from paddle_tpu_torch.distributed import strategy as ts
    j, t = js.DistributedStrategy(), ts.DistributedStrategy()
    assert set(_public(j)) == set(_public(t))
    for k, v in _public(j).items():
        tv = getattr(t, k)
        if dataclasses.is_dataclass(v):
            assert type(tv).__name__ == type(v).__name__, k
            assert dataclasses.asdict(tv) == dataclasses.asdict(v), k
        else:
            assert tv == v, k
    assert t._fuse_grad_size_in_TFLOPS == j._fuse_grad_size_in_TFLOPS
    classes = [n for n in dir(js) if dataclasses.is_dataclass(
        getattr(js, n)) and isinstance(getattr(js, n), type)]
    assert classes and all(hasattr(ts, n) for n in classes)
    for n in classes:
        jf = [(f.name, f.type) for f in dataclasses.fields(getattr(js, n))]
        tf = [(f.name, f.type) for f in dataclasses.fields(getattr(ts, n))]
        assert jf == tf, n


def _configure(s):
    s.amp = True
    s.amp_configs = {"dtype": "float16", "init_loss_scaling": 1024.0,
                     "custom_white_list": ["softmax"]}
    s.recompute = True
    s.recompute_configs = {"checkpoints": ["gpt.layers.0"]}
    s.gradient_merge = True
    s.gradient_merge_configs = {"k_steps": 4, "avg": False}
    s.hybrid_configs = {"dp_degree": 2, "sep_degree": 1}
    s.sharding_configs = {"stage": 2, "offload": True, "nonexistent": 3}
    s.gradient_scale_configs = {"scale_strategy": "sum"}
    s.scan_steps = 4
    s.lamb_configs = {"exclude_from_weight_decay": ["bias"]}
    s.nccl_comm_num = 2


def test_to_dict_and_prototxt_round_trip_match_jax(tmp_path):
    from paddle_tpu.distributed.strategy import DistributedStrategy as JS
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    j, t = JS(), DistributedStrategy()
    _configure(j)
    _configure(t)
    assert t.to_dict() == j.to_dict()
    assert not hasattr(t.sharding_configs, "nonexistent")
    path = tmp_path / "s.prototxt"
    t.save_to_prototxt(str(path))
    back = DistributedStrategy()
    back.load_from_prototxt(str(path))
    assert back.to_dict() == t.to_dict()
    j.save_to_prototxt(str(tmp_path / "j.prototxt"))
    assert path.read_text() == (tmp_path / "j.prototxt").read_text()
    assert repr(t) == repr(j)


def test_buckets_and_transform_order_match_jax():
    from paddle_tpu.distributed.fleet import strategy_compiler as jc
    from paddle_tpu_torch.distributed.fleet import strategy_compiler as tc
    assert tc.TRANSFORM_ORDER == jc.TRANSFORM_ORDER
    assert tc.CONSUMED_HERE == jc.CONSUMED_HERE
    assert set(tc.CONSUMED_ELSEWHERE) == set(jc.CONSUMED_ELSEWHERE)
    assert set(tc.ABSORBED) == set(jc.ABSORBED)
    assert tc.GPU_ONLY == jc.GPU_ONLY
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    fields = set(_public(DistributedStrategy()))
    buckets = [tc.CONSUMED_HERE, set(tc.CONSUMED_ELSEWHERE),
               set(tc.ABSORBED), set(tc.GPU_ONLY)]
    for f in fields:
        assert sum(f in b for b in buckets) == 1, f


# each: {field: value} set on both strategies (dicts merge into configs);
# "opt" picks the optimizer handed to the compiler
MATRIX = {
    "none": {},
    "amp_bf16": {"amp": True},
    "amp_fp16": {"amp": True, "amp_configs": {"dtype": "float16"}},
    "recompute": {"recompute": True},
    "selective": {"recompute": True,
                  "recompute_configs": {"checkpoints": ["gpt.layers"]}},
    "merge": {"gradient_merge": True,
              "gradient_merge_configs": {"k_steps": 3, "avg": False}},
    "merge_k1": {"gradient_merge": True},
    "offload": {"sharding": True,
                "sharding_configs": {"stage": 3, "offload": True}},
    "hybrid_sharding": {"hybrid_configs": {"sharding_degree": 2}},
    "lars": {"lars": True, "opt": "momentum"},
    "lars_on_adam": {"lars": True, "opt": "adam"},
    "lamb": {"lamb": True, "opt": "adam"},
    "lamb_on_sgd": {"lamb": True, "opt": "sgd"},
    "lars_lamb": {"lars": True, "lamb": True, "opt": "sgd"},
    "fp16_allreduce": {"fp16_allreduce": True},
    "quant_over_fp16": {"fp16_allreduce": True, "quant_allreduce": True},
    "grad_sum": {"gradient_scale_configs": {"scale_strategy": "sum"}},
    "localsgd_amp": {"localsgd": True, "amp": True, "recompute": True,
                     "gradient_merge": True,
                     "gradient_merge_configs": {"k_steps": 2}},
    "localsgd_sharding": {"localsgd": True, "sharding": True},
    "adaptive_localsgd": {"adaptive_localsgd": True,
                          "fp16_allreduce": True, "scan_steps": 4},
    "pipeline_scan": {"pipeline": True, "scan_steps": 8},
    "sequence_parallel": {"sequence_parallel": True},
    "sep_degree": {"hybrid_configs": {"sep_degree": 2, "sep_impl": "ulysses"}},
    "scan": {"scan_steps": 4, "amp": True},
    "everything": {"qat": True, "sync_batch_norm": True, "asp": True,
                   "numerics": True, "amp": True, "recompute": True},
    "inert_knobs": {"nccl_comm_num": 2, "fuse_grad_size_in_MB": 64,
                    "auto": True},
}


def _optimizer(pkg, kind):
    if pkg == "jax":
        import paddle_tpu as paddle
        from paddle_tpu import optimizer as o
        params = [paddle.create_parameter([3], "float32")]
        clip = paddle.nn.ClipGradByGlobalNorm(1.0)
    else:
        import torch
        from paddle_tpu_torch import optimizer as o
        from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
        params = [torch.nn.Parameter(torch.zeros(3))]
        clip = ClipGradByGlobalNorm(1.0)
    kw = dict(learning_rate=0.05, parameters=params, grad_clip=clip)
    return {"adam": lambda: o.AdamW(beta1=0.8, beta2=0.99, epsilon=1e-7,
                                    **kw),
            "momentum": lambda: o.Momentum(momentum=0.7, **kw),
            "sgd": lambda: o.SGD(**kw)}[kind]()


def _compile(pkg, case):
    if pkg == "jax":
        from paddle_tpu.distributed.fleet.strategy_compiler import \
            StrategyCompiler
        from paddle_tpu.distributed.strategy import DistributedStrategy
    else:
        from paddle_tpu_torch.distributed.fleet.strategy_compiler import \
            StrategyCompiler
        from paddle_tpu_torch.distributed.strategy import \
            DistributedStrategy
    cfg = dict(MATRIX[case])
    opt = _optimizer(pkg, cfg.pop("opt", "adam"))
    s = DistributedStrategy()
    for k, v in cfg.items():
        setattr(s, k, v)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        plan = StrategyCompiler().compile(s, opt)
    return plan, [str(x.message) for x in w], opt


@pytest.mark.parametrize("case", sorted(MATRIX))
def test_compiled_plan_matches_jax(case):
    jplan, jwarn, jopt = _compile("jax", case)
    tplan, twarn, topt = _compile("port", case)
    for f in dataclasses.fields(jplan):
        jv, tv = getattr(jplan, f.name), getattr(tplan, f.name)
        if dataclasses.is_dataclass(jv):
            assert dataclasses.asdict(tv) == dataclasses.asdict(jv), f.name
        else:
            assert tv == jv, f.name
    assert tplan.describe() == jplan.describe()
    # conflicts word for word; an inert knob warns on both sides
    conflicts = [m for m in jwarn if "NO effect" not in m
                 and "auto/semi_auto" not in m]
    assert [m for m in twarn if "NO effect" not in m
            and "auto/semi_auto" not in m] == conflicts
    knobs = sorted(m.split("=")[0] for m in jwarn if "NO effect" in m)
    assert sorted(m.split("=")[0] for m in twarn if "NO effect" in m) == \
        knobs
    assert sum("auto/semi_auto" in m for m in twarn) == \
        sum("auto/semi_auto" in m for m in jwarn)
    # the (possibly swapped) optimizer: same class and settings
    jo, to = jplan.optimizer, tplan.optimizer
    assert type(to).__name__ == type(jo).__name__
    assert (to is topt) == (jo is jopt)
    for attr in ("_learning_rate", "_momentum", "_lars_coeff", "_epsilon",
                 "_beta1", "_beta2", "_weight_decay"):
        if hasattr(jo, attr):
            assert getattr(to, attr) == getattr(jo, attr), attr
    if type(jo).__name__ in ("LarsMomentum", "Lamb"):
        assert to._parameter_list == topt._parameter_list
        assert to._grad_clip is topt._grad_clip


def test_lamb_swap_excludes_by_name():
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    from paddle_tpu_torch.distributed.fleet.strategy_compiler import \
        StrategyCompiler
    s = DistributedStrategy()
    s.lamb = True
    s.lamb_configs = {"exclude_from_weight_decay": ["bias", "norm"]}
    plan = StrategyCompiler().compile(s, _optimizer("port", "adam"))
    assert plan.optimizer._leaf_wd("gpt.layers.0.norm1.weight", 0.01) == 0.0
    assert plan.optimizer._leaf_wd("lm_head.bias", 0.01) == 0.0
    assert plan.optimizer._leaf_wd("lm_head.weight", 0.01) == 0.01


def test_env_flags_fill_the_defaults(monkeypatch):
    from paddle_tpu_torch.distributed.fleet.strategy_compiler import \
        StrategyCompiler
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    monkeypatch.setenv("FLAGS_scan_chunk", "6")
    monkeypatch.setenv("FLAGS_quant_allreduce", "true")
    plan = StrategyCompiler().compile(DistributedStrategy())
    assert plan.scan_steps == 6 and plan.comm_quant is not None
    assert plan.applied == ["quant_allreduce", "scan"]
    assert np.isclose(plan.comm_quant.block_size, 256)
