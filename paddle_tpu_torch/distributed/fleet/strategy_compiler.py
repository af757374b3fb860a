"""Strategy -> execution composition (counterpart of
paddle_tpu/distributed/fleet/strategy_compiler.py:97-440).

Reference: fleet/base/strategy_compiler.py:213 ranks and chains ~17
meta-optimizers, each of which rewrites the static program. Here, as in
the JAX package, each strategy flag becomes a transformation of the train
step (parallel/api.py):

    amp             -> the forward under auto_cast, plus (fp16) dynamic
                       loss-scale state kept on the device by the step
    lars / lamb     -> swap the inner optimizer (meta_optimizers/{lars,lamb})
    recompute       -> a checkpoint around the loss, or around the named
                       sublayers (recompute_configs.checkpoints)
    gradient_merge  -> k-1 steps bank grads, the k-th applies
                       (gradient_merge_optimizer.py:72 analog)
    sharding        -> the ZeRO stage (nothing to shard on one device) and
                       the optimizer-state offload
    localsgd, pipeline, sequence parallelism -> need several ranks

`StrategyCompiler.compile` is the JAX compiler line for line: the same
plan fields, `applied` order, conflict rules and warnings. What the plan
asks of the step, and which fields the port's step refuses, is
`parallel/api.py`'s business.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..strategy import AMPConfig, DistributedStrategy, QuantAllreduceConfig


def _env_flag(name, default):
    """A FLAGS_* default from the environment, parsed by the default's type
    as the JAX package's flags module parses it at import."""
    import os
    v = os.environ.get(name)
    if v is None:
        return default
    if isinstance(default, bool):
        return v.lower() in ("1", "true", "yes")
    return type(default)(v)

# Application order mirrors the reference's rank: rewrites that change the
# numerics of the forward first, optimizer swaps next, execution-layout
# transforms last.
TRANSFORM_ORDER = ("qat", "sync_batch_norm", "amp", "lars", "lamb", "asp",
                   "recompute", "gradient_merge", "fp16_allreduce",
                   "quant_allreduce", "gradient_scale", "localsgd",
                   "adaptive_localsgd", "sequence_parallel", "sharding",
                   "pipeline", "scan", "numerics")

# Every public DistributedStrategy field falls in exactly one bucket, the
# JAX package's buckets (tests/test_torch_strategy.py holds the two equal),
# so a new field can never rot into a silently-dead flag:
#  - consumed here (compile reads it into the plan),
#  - CONSUMED_ELSEWHERE (another subsystem reads it),
#  - ABSORBED (the responsibility is carried by the framework itself; the
#    flag cannot change anything because the behavior is always on/owned),
#  - GPU_ONLY (tunes NCCL/cuDNN machinery the one-device step does not
#    have: compile WARNS when one is set away from its default instead of
#    silently ignoring it).
CONSUMED_HERE = frozenset({
    "amp", "amp_configs", "lars", "lars_configs", "lamb", "lamb_configs",
    "recompute", "recompute_configs", "gradient_merge",
    "gradient_merge_configs", "localsgd", "localsgd_configs",
    "adaptive_localsgd", "adaptive_localsgd_configs", "sequence_parallel",
    "sharding", "sharding_configs", "pipeline", "pipeline_configs",
    "hybrid_configs", "fp16_allreduce", "gradient_scale_configs",
    "sync_batch_norm", "asp", "qat", "auto", "semi_auto", "scan_steps",
    "quant_allreduce", "quant_allreduce_configs", "numerics",
})
CONSUMED_ELSEWHERE = {
    "a_sync": "fleet.init_worker/the_one_ps (PS async communicator)",
    "a_sync_configs": "the_one_ps Communicator merge/queue knobs",
    "dgc": "fleet/dgc.py maybe_wrap_dgc (Momentum only)",
    "dgc_configs": "fleet/dgc.py rampup/sparsity schedule",
    "tensor_parallel": "fleet._init_hybrid_parallel_env (mesh model axis)",
    "tensor_parallel_configs": "fleet TP RNG seed (tensor_init_seed)",
    "elastic": "distributed/launch.py --elastic / PADDLE_ELASTIC_* watch loop",
}
ABSORBED = {
    "find_unused_parameters": "a parameter without a gradient is skipped "
                              "by the update; no reducer hook graph",
    "fuse_all_reduce_ops": "no collective on one device",
    "without_graph_optimization": "eager PyTorch: no graph pass to switch "
                                  "off",
    "build_strategy": "ParallelExecutor build knobs; no graph build",
    "execution_strategy": "ParallelExecutor exec knobs; eager dispatch",
    "heter_ccl_mode": "no collective backend on one device",
}
GPU_ONLY = {
    "nccl_comm_num": 1,
    "sync_nccl_allreduce": True,
    "use_hierarchical_allreduce": False,
    "hierarchical_allreduce_inter_nranks": 0,
    "cudnn_exhaustive_search": False,
    "conv_workspace_size_limit": 512,
    "cudnn_batchnorm_spatial_persistent": False,
    "fuse_grad_size_in_MB": 32,
    "fuse_grad_size_in_TFLOPS": 50.0,
    "fuse_grad_size_in_num": 8,
    "last_comm_group_size_MB": 1.0,
    "_calc_comm_same_stream": False,
}


@dataclasses.dataclass
class CompiledStrategy:
    """The resolved execution plan for one train step."""

    applied: List[str] = dataclasses.field(default_factory=list)
    amp: Optional[AMPConfig] = None
    remat: bool = False
    # selective recompute: sublayer names/prefixes to checkpoint instead of
    # the whole loss (recompute_configs.checkpoints analog)
    recompute_checkpoints: List[str] = dataclasses.field(default_factory=list)
    accumulate_steps: int = 1
    gradient_merge_avg: bool = True
    zero_stage: int = 0
    zero_offload: bool = False
    zero_min_numel: int = 1024
    localsgd_k: int = 0
    localsgd_begin: int = 1
    localsgd_adaptive: bool = False
    pipeline: bool = False
    sequence_parallel: bool = False
    sequence_parallel_impl: str = "ring"  # ring | ulysses | gspmd
    # grads pass through this dtype around the cross-rank reduction
    # (fp16_allreduce_optimizer.py:148 analog)
    fp16_allreduce_dtype: Optional[str] = None
    # EQuARX-style blockwise int8 quantized grad all-reduce
    # (distributed/compression.py); None = full-precision sync
    comm_quant: Optional[QuantAllreduceConfig] = None
    grad_scale: str = "avg"  # gradient_scale_configs: avg | sum
    sync_batch_norm: bool = False
    asp: bool = False
    qat: bool = False
    # K steps a chunk (parallel.ScanTrainStep);
    # 1 = eager per-step dispatch
    scan_steps: int = 1
    # training numerics observatory (obs.numerics): per-group grad/param
    # norms + update ratios traced into the step's extras when armed
    numerics: bool = False
    optimizer = None  # possibly swapped by lars/lamb

    def describe(self) -> str:
        return " -> ".join(self.applied) if self.applied else "(raw)"


class StrategyCompiler:
    """fleet/base/strategy_compiler.py analog over step transforms."""

    def compile(self, strategy: Optional[DistributedStrategy], optimizer=None,
                mesh=None) -> CompiledStrategy:
        plan = CompiledStrategy()
        plan.optimizer = optimizer
        if strategy is None:
            return plan

        conflicts = []
        self._warn_inert_knobs(strategy)
        if getattr(strategy, "qat", False):
            # routed by parallelize(): ImperativeQuantAware swaps
            # Linear/Conv sublayers for fake-quant wrappers before the step
            # is traced (qat meta-optimizer analog)
            plan.qat = True
            plan.applied.append("qat")
        if getattr(strategy, "sync_batch_norm", False):
            # routed by parallelize(): BatchNorm* -> SyncBatchNorm swap; the
            # SPMD step then computes batch stats over the sharded batch
            plan.sync_batch_norm = True
            plan.applied.append("sync_batch_norm")
        if getattr(strategy, "amp", False):
            plan.amp = strategy.amp_configs
            plan.applied.append("amp")
        if getattr(strategy, "lars", False) and optimizer is not None:
            plan.optimizer = self._to_lars(optimizer, strategy.lars_configs)
            plan.applied.append("lars")
        if getattr(strategy, "lamb", False) and optimizer is not None:
            plan.optimizer = self._to_lamb(plan.optimizer,
                                           strategy.lamb_configs)
            plan.applied.append("lamb")
        if getattr(strategy, "asp", False):
            # 2:4 masks re-applied after every update (asp_optimizer.py
            # analog); the port's step refuses it until incubate/asp is
            # ported
            plan.asp = True
            plan.applied.append("asp")
        if getattr(strategy, "recompute", False):
            plan.remat = True
            cfg = getattr(strategy, "recompute_configs", None)
            if cfg is not None and getattr(cfg, "checkpoints", None):
                # selective recompute: only the named sublayers remat
                # (recompute_configs.checkpoints, distributed_strategy.proto:26)
                plan.recompute_checkpoints = list(cfg.checkpoints)
            plan.applied.append("recompute")
        if getattr(strategy, "fp16_allreduce", False):
            # grads pass through fp16 around the cross-rank reduction
            # (fp16_allreduce_optimizer.py:148: cast fp32->fp16, allreduce,
            # cast back). At degree 1 the step rounds fp32 grads through
            # fp16 where the reduction would be, as the JAX step does.
            plan.fp16_allreduce_dtype = "float16"
            plan.applied.append("fp16_allreduce")
        quant_on = bool(getattr(strategy, "quant_allreduce", False))
        if not quant_on:
            # strategy left at the default: the env flag may still opt in
            # (FLAGS_scan_chunk pattern)
            quant_on = bool(_env_flag("FLAGS_quant_allreduce", False))
        if quant_on:
            cfg = getattr(strategy, "quant_allreduce_configs", None)
            plan.comm_quant = (cfg if isinstance(cfg, QuantAllreduceConfig)
                               else QuantAllreduceConfig()).validate()
            plan.applied.append("quant_allreduce")
            if plan.fp16_allreduce_dtype:
                # int8 wire subsumes the fp16 cast: quantizing an
                # already-fp16-rounded grad would just stack rounding error
                conflicts.append(
                    "quant_allreduce supersedes fp16_allreduce (the int8 "
                    "wire already compresses past fp16); disabling "
                    "fp16_allreduce")
                plan.fp16_allreduce_dtype = None
                plan.applied.remove("fp16_allreduce")
        gsc = getattr(strategy, "gradient_scale_configs", None) or {}
        scale_strategy = gsc.get("scale_strategy", "avg") \
            if isinstance(gsc, dict) else getattr(gsc, "scale_strategy", "avg")
        if scale_strategy not in ("avg", "sum"):
            # 'customized' means the user's program already scales the loss —
            # meaningless for a step the framework itself traces; fail loud
            raise ValueError(
                f"gradient_scale_configs scale_strategy={scale_strategy!r} "
                "is not supported on the compiled step (use 'avg' or 'sum')")
        plan.grad_scale = scale_strategy
        if scale_strategy != "avg":
            plan.applied.append("gradient_scale")
        if getattr(strategy, "gradient_merge", False):
            plan.accumulate_steps = max(
                strategy.gradient_merge_configs.k_steps, 1)
            plan.gradient_merge_avg = strategy.gradient_merge_configs.avg
            if plan.accumulate_steps > 1:
                plan.applied.append("gradient_merge")
        if getattr(strategy, "localsgd", False):
            plan.localsgd_k = max(strategy.localsgd_configs.k_steps, 1)
            plan.localsgd_begin = strategy.localsgd_configs.begin_step
            plan.applied.append("localsgd")
        elif getattr(strategy, "adaptive_localsgd", False):
            # AdaptiveLocalSGD (localsgd_optimizer.py:197): k adapts from the
            # loss/lr ratio at every sync point
            cfg = strategy.adaptive_localsgd_configs
            plan.localsgd_k = max(cfg.init_k_steps, 1)
            plan.localsgd_begin = cfg.begin_step
            plan.localsgd_adaptive = True
            plan.applied.append("adaptive_localsgd")
        if getattr(strategy, "sequence_parallel", False) or \
                strategy.hybrid_configs.sep_degree > 1:
            # parity-plus: shard the token/sequence dim over the `sep`
            # mesh axis (ring/Ulysses primitives in parallel.ring_attention;
            # the multi-GPU step shards activations; ROADMAP §1 item 8)
            plan.sequence_parallel = True
            plan.sequence_parallel_impl = getattr(
                strategy.hybrid_configs, "sep_impl", "ring") or "ring"
            plan.applied.append("sequence_parallel")
        if getattr(strategy, "sharding", False):
            plan.zero_stage = strategy.sharding_configs.stage
            plan.zero_offload = strategy.sharding_configs.offload
            plan.zero_min_numel = getattr(strategy.sharding_configs,
                                          "min_shard_numel", 1024)
            plan.applied.append("sharding")
        elif strategy.hybrid_configs.sharding_degree > 1:
            plan.zero_stage = 1
            plan.applied.append("sharding")
        if getattr(strategy, "pipeline", False) or (
                mesh is not None and "pipe" in getattr(mesh, "axis_names",
                                                       ())
                and mesh.shape["pipe"] > 1):
            plan.pipeline = True
            plan.applied.append("pipeline")
        scan_k = int(getattr(strategy, "scan_steps", 1) or 1)
        if scan_k <= 1:
            # strategy left at the default: the env flag may still opt in
            scan_k = int(_env_flag("FLAGS_scan_chunk", 0) or 1)
        if scan_k > 1:
            plan.scan_steps = scan_k
            plan.applied.append("scan")
        if getattr(strategy, "numerics", False):
            plan.numerics = True
            plan.applied.append("numerics")

        # conflict resolution (reference _disable_strategy protocol)
        localsgd_name = ("adaptive_localsgd" if plan.localsgd_adaptive
                         else "localsgd")
        if plan.localsgd_k and (plan.amp or plan.remat
                                or plan.accumulate_steps > 1):
            dropped = [n for n in ("amp", "recompute", "gradient_merge")
                       if n in plan.applied]
            conflicts.append(
                "LocalSGDTrainStep does not compose with "
                f"{'/'.join(dropped)} yet; disabling them for this step")
            plan.amp = None
            plan.remat = False
            plan.accumulate_steps = 1
            for n in dropped:
                plan.applied.remove(n)
        if plan.localsgd_k and plan.zero_stage:
            conflicts.append(f"{localsgd_name} is incompatible with ZeRO "
                             "sharding (local params cannot also be "
                             "shard-owned); disabling it")
            plan.localsgd_k = 0
            plan.localsgd_adaptive = False
            plan.applied.remove(localsgd_name)
        if plan.localsgd_k and plan.pipeline:
            conflicts.append(f"{localsgd_name} is incompatible with pipeline "
                             "parallelism; disabling it")
            plan.localsgd_k = 0
            plan.localsgd_adaptive = False
            plan.applied.remove(localsgd_name)
        if plan.asp and plan.pipeline:
            # the pipeline step stores decoder params stacked/interleaved;
            # per-name mask re-application over that layout is not wired —
            # fail loud rather than let the 2:4 sparsity silently decay
            raise ValueError(
                "strategy.asp does not compose with pipeline parallelism "
                "(mask re-application over the stacked stage layout is not "
                "implemented); train with pp_degree=1 or drop asp")
        if plan.localsgd_k:
            dropped = []
            if plan.fp16_allreduce_dtype:
                # LocalSGD has no per-step grad collective to compress
                plan.fp16_allreduce_dtype = None
                plan.applied.remove("fp16_allreduce")
                dropped.append("fp16_allreduce")
            if plan.comm_quant is not None:
                # same reason: no per-step grad collective to quantize
                plan.comm_quant = None
                plan.applied.remove("quant_allreduce")
                dropped.append("quant_allreduce")
            if plan.grad_scale != "avg":
                plan.grad_scale = "avg"
                plan.applied.remove("gradient_scale")
                dropped.append("gradient_scale='sum'")
            if plan.asp:
                plan.asp = False
                plan.applied.remove("asp")
                dropped.append("asp")
            if dropped:
                conflicts.append(
                    f"{'/'.join(dropped)} do not compose with "
                    f"{localsgd_name}'s local-update step; disabling them")
        if plan.scan_steps > 1 and plan.localsgd_k:
            # LocalSGDTrainStep keeps per-rank host state and a host-side
            # sync decision between steps; fusing steps on device would skip
            # the sync points
            conflicts.append(
                f"scan_steps={plan.scan_steps} does not compose with "
                f"{localsgd_name}'s host-side sync loop; disabling scan")
            plan.scan_steps = 1
            plan.applied.remove("scan")
        if plan.scan_steps > 1 and plan.pipeline:
            # PipelinedTrainStep owns its own microbatch schedule per
            # dispatch; wrapping it in an outer scan is unimplemented
            conflicts.append(
                f"scan_steps={plan.scan_steps} does not compose with "
                "pipeline parallelism; disabling scan")
            plan.scan_steps = 1
            plan.applied.remove("scan")
        if conflicts:
            import warnings
            for c in conflicts:
                warnings.warn(c, stacklevel=3)

        plan.applied.sort(key=TRANSFORM_ORDER.index)
        return plan

    @staticmethod
    def _warn_inert_knobs(strategy):
        """GPU-only knobs warn when moved off their default (a flag that
        does nothing silently is worse than one that raises); auto and
        semi_auto warn that they add nothing."""
        import warnings
        for knob, default in GPU_ONLY.items():
            val = getattr(strategy, knob, default)
            if val != default:
                warnings.warn(
                    f"DistributedStrategy.{knob}={val!r} tunes NCCL "
                    "collective machinery; it has NO effect here (the "
                    "port's step runs on one device and has no collective "
                    "to tune)", stacklevel=4)
        if getattr(strategy, "auto", False) or \
                getattr(strategy, "semi_auto", False):
            warnings.warn(
                "strategy.auto/semi_auto request automatic parallelization; "
                "the port's step runs on one device, so the flag adds "
                "nothing beyond the default behavior", stacklevel=4)

    @staticmethod
    def _to_lars(optimizer, cfg):
        """Momentum → LarsMomentum keeping lr/params (lars_optimizer.py:
        like the reference meta-optimizer, applies ONLY to Momentum — other
        optimizers pass through with a warning, never a silent algorithm
        swap)."""
        from ...optimizer.optimizer import SGD, LarsMomentum, Momentum
        if isinstance(optimizer, LarsMomentum):
            return optimizer
        if not isinstance(optimizer, (Momentum, SGD)):
            import warnings
            warnings.warn(
                f"strategy.lars applies to Momentum/SGD, not "
                f"{type(optimizer).__name__}; keeping the user optimizer",
                stacklevel=3)
            return optimizer
        momentum = getattr(optimizer, "_momentum", 0.9)
        return LarsMomentum(
            learning_rate=optimizer._learning_rate,
            momentum=momentum, lars_coeff=cfg.lars_coeff,
            lars_weight_decay=cfg.lars_weight_decay, epsilon=cfg.epsilon,
            parameters=optimizer._parameter_list,
            grad_clip=optimizer._grad_clip)

    @staticmethod
    def _to_lamb(optimizer, cfg):
        """Adam-family → Lamb keeping lr/params (lamb_optimizer.py; only
        Adam-family optimizers are converted, mirroring the reference)."""
        from ...optimizer.optimizer import Adam, Lamb
        if isinstance(optimizer, Lamb):
            return optimizer
        if not isinstance(optimizer, Adam):
            import warnings
            warnings.warn(
                f"strategy.lamb applies to Adam-family optimizers, not "
                f"{type(optimizer).__name__}; keeping the user optimizer",
                stacklevel=3)
            return optimizer
        exclude = set(cfg.exclude_from_weight_decay or [])
        fn = (lambda p: any(e in (p.name or "") for e in exclude)) \
            if exclude else None
        return Lamb(
            learning_rate=optimizer._learning_rate,
            lamb_weight_decay=cfg.lamb_weight_decay,
            beta1=getattr(optimizer, "_beta1", 0.9),
            beta2=getattr(optimizer, "_beta2", 0.999),
            epsilon=getattr(optimizer, "_epsilon", 1e-6),
            parameters=optimizer._parameter_list,
            grad_clip=optimizer._grad_clip,
            exclude_from_weight_decay_fn=fn)
