"""DistributedStrategy (counterpart of paddle_tpu/distributed/strategy.py:17-284;
reference: fleet/base/distributed_strategy.py:105 backed by
distributed_strategy.proto:159).

One typed config object driving all parallelism; proto messages become nested
dataclasses, field for field the JAX package's (the same names, defaults,
dict assignment into `*_configs`, `to_dict` and the JSON "prototxt" round
trip). Nothing here runs anything: `distributed/fleet/strategy_compiler.py`
reads it into a plan and `parallel.parallelize` executes the plan.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class RecomputeConfig:  # proto RecomputeConfig:26
    checkpoints: List[str] = field(default_factory=list)
    enable_offload: bool = False
    checkpoint_shape: List[int] = field(default_factory=list)


@dataclass
class ShardingConfig:  # proto ShardingConfig:32
    sharding_segment_strategy: str = "segment_broadcast_MB"
    segment_broadcast_MB: float = 32.0
    segment_anchors: List[str] = field(default_factory=list)
    sharding_degree: int = 8
    mp_degree: int = 1
    dp_degree: int = 1
    pp_degree: int = 1
    stage: int = 1
    offload: bool = False
    gradient_merge_acc_step: int = 1
    optimize_offload: bool = False
    pp_allreduce_in_optimize: bool = False
    # not in the reference's proto: tensors below this element count stay
    # replicated instead
    # of ZeRO-sharded (size segmentation, segment_broadcast_MB analog)
    min_shard_numel: int = 1024


@dataclass
class HybridConfig:  # proto HybridConfig:47
    dp_degree: int = -1
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sep_degree: int = 1  # sequence/context parallel (parity-plus axis)
    sep_impl: str = "ring"  # ring | ulysses | gspmd attention on the sep axis
    ep_degree: int = 1   # expert parallel (parity-plus axis)


@dataclass
class AMPConfig:  # proto AMPConfig:54
    init_loss_scaling: float = 32768.0
    incr_every_n_steps: int = 1000
    decr_every_n_nan_or_inf: int = 2
    incr_ratio: float = 2.0
    decr_ratio: float = 0.8
    use_dynamic_loss_scaling: bool = True
    custom_white_list: List[str] = field(default_factory=list)
    custom_black_list: List[str] = field(default_factory=list)
    custom_black_varnames: List[str] = field(default_factory=list)
    use_pure_fp16: bool = False
    use_fp16_guard: bool = True
    dtype: str = "bfloat16"  # the JAX package's default; "float16" for parity


@dataclass
class LocalSGDConfig:  # proto LocalSGDConfig:68
    k_steps: int = 1
    begin_step: int = 1


@dataclass
class AdaptiveLocalSGDConfig:
    init_k_steps: int = 1
    begin_step: int = 1


@dataclass
class GradientMergeConfig:  # proto GradientMergeConfig:78
    k_steps: int = 1
    avg: bool = True


@dataclass
class DGCConfig:  # proto DGCConfig:83
    rampup_begin_step: int = 0
    rampup_step: int = 1
    sparsity: List[float] = field(default_factory=lambda: [0.999])


@dataclass
class LarsConfig:  # proto LarsConfig:89
    lars_coeff: float = 0.001
    lars_weight_decay: float = 0.0005
    epsilon: float = 0.0
    exclude_from_weight_decay: List[str] = field(default_factory=list)


@dataclass
class LambConfig:  # proto LambConfig:96
    lamb_weight_decay: float = 0.01
    exclude_from_weight_decay: List[str] = field(default_factory=list)


@dataclass
class PipelineConfig:  # proto PipelineConfig:148
    micro_batch_size: int = 1
    accumulate_steps: int = 1
    schedule_mode: str = "1F1B"
    p2p_cache_shape: bool = True
    # parity-plus: Megatron-style interleaved schedule (virtual pipeline
    # stages); 1 = plain 1F1B
    virtual_pp_degree: int = 1


@dataclass
class TensorParallelConfig:  # proto TensorParallelConfig:154
    tensor_parallel_degree: int = 1
    tensor_init_seed: int = -1


@dataclass
class QuantAllreduceConfig:  # not in the proto (EQuARX-style quantized grad sync)
    block_size: int = 256          # elements per absmax scale block
    dtype: str = "int8"            # wire payload dtype (int8 only for now)
    error_feedback: bool = False   # carry the rounding residual forward
    stochastic_rounding: bool = True
    # tensors below this element count sync in full precision: a bias or
    # layernorm vector saves nothing on the wire and the scale overhead +
    # quantization noise dominate (same size-segmentation rationale as
    # ShardingConfig.min_shard_numel)
    min_quant_numel: int = 1024

    def validate(self) -> "QuantAllreduceConfig":
        if self.dtype != "int8":
            raise ValueError(
                f"quant_allreduce dtype {self.dtype!r} is not supported "
                "(int8 is the only wire payload implemented)")
        if self.block_size < 1:
            raise ValueError(
                f"quant_allreduce block_size must be >= 1, got "
                f"{self.block_size}")
        return self


@dataclass
class AsyncConfig:  # proto AsyncConfig:133 (PS mode; interface parity only)
    k_steps: int = -1
    max_merge_var_num: int = 1
    send_queue_size: int = 16
    independent_recv_thread: bool = False
    thread_pool_size: int = 1
    send_wait_times: int = 1
    runtime_split_send_recv: bool = False


class DistributedStrategy:
    def __init__(self):
        # strategy switches (proto DistributedStrategy:159 field-for-field)
        self.recompute = False
        self.recompute_configs = RecomputeConfig()
        self.sharding = False
        self.sharding_configs = ShardingConfig()
        self.hybrid_configs = HybridConfig()
        self.amp = False
        self.amp_configs = AMPConfig()
        self.localsgd = False
        self.localsgd_configs = LocalSGDConfig()
        self.adaptive_localsgd = False
        self.adaptive_localsgd_configs = AdaptiveLocalSGDConfig()
        self.gradient_merge = False
        self.gradient_merge_configs = GradientMergeConfig()
        self.dgc = False
        self.dgc_configs = DGCConfig()
        self.lars = False
        self.lars_configs = LarsConfig()
        self.lamb = False
        self.lamb_configs = LambConfig()
        self.pipeline = False
        self.pipeline_configs = PipelineConfig()
        self.tensor_parallel = False
        self.tensor_parallel_configs = TensorParallelConfig()
        self.a_sync = False
        self.a_sync_configs = AsyncConfig()
        self.fp16_allreduce = False
        # parity-plus: EQuARX-style blockwise int8 quantized gradient
        # all-reduce (distributed/compression.py). Off by default — zero
        # behavior change; FLAGS_quant_allreduce fills the default when the
        # strategy is left untouched.
        self.quant_allreduce = False
        self.quant_allreduce_configs = QuantAllreduceConfig()
        self.find_unused_parameters = False
        self.last_comm_group_size_MB = 1.0
        self.fuse_grad_size_in_MB = 32
        self.fuse_grad_size_in_TFLOPS = 50.0
        self.nccl_comm_num = 1
        self.sync_nccl_allreduce = True
        self.sync_batch_norm = False
        self.fuse_all_reduce_ops = True
        self.gradient_scale_configs = {"scale_strategy": "avg"}
        self.heter_ccl_mode = False
        self.cudnn_exhaustive_search = False  # accepted, ignored
        self.conv_workspace_size_limit = 512
        self.cudnn_batchnorm_spatial_persistent = False
        self.sequence_parallel = False  # parity-plus: SP over the sep axis
        # parity-plus: K train steps a call over a stacked [K, ...] batch
        # chunk (parallel.ScanTrainStep);
        # 1 = eager per-step dispatch. FLAGS_scan_chunk overrides when left
        # at the default.
        self.scan_steps = 1
        # parity-plus: arm the training numerics observatory
        # (obs.numerics): per-group grad/param norms and update ratios
        # computed by the step (parallel/api.py). Off by default.
        self.numerics = False
        self.without_graph_optimization = False
        self.asp = False
        self.qat = False
        self.auto = False
        self.semi_auto = False
        # ParallelExecutor-era knobs (BuildStrategy/ExecutionStrategy
        # messages + hierarchical-allreduce ring tuning): accepted for
        # config-surface parity; the compiler warns when one is moved
        self.build_strategy = None
        self.execution_strategy = None
        self.elastic = False
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 0
        self.fuse_grad_size_in_num = 8
        self._calc_comm_same_stream = False

    @property
    def _fuse_grad_size_in_TFLOPS(self):
        # the reference exposes this private-named property over the same
        # proto field as the public name — alias, not a second copy
        return self.fuse_grad_size_in_TFLOPS

    @_fuse_grad_size_in_TFLOPS.setter
    def _fuse_grad_size_in_TFLOPS(self, v):
        self.fuse_grad_size_in_TFLOPS = v

    def _config_dict(self, obj, value: Dict[str, Any]):
        if isinstance(obj, dict):  # dict-shaped configs (gradient_scale)
            obj.update(value)
            return
        for k, v in value.items():
            if hasattr(obj, k):
                setattr(obj, k, v)

    def __setattr__(self, key, value):
        # dict assignment to *_configs merges into the dataclass (paddle API)
        if key.endswith("_configs") and isinstance(value, dict) and \
                hasattr(self, key):
            self._config_dict(getattr(self, key), value)
        elif key == "hybrid_configs" and isinstance(value, dict):
            self._config_dict(self.hybrid_configs, value)
        else:
            object.__setattr__(self, key, value)

    def to_dict(self):
        out = {}
        for k, v in self.__dict__.items():
            if dataclasses.is_dataclass(v):
                out[k] = dataclasses.asdict(v)
            else:
                out[k] = v
        return out

    def save_to_prototxt(self, output):
        with open(output, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    def load_from_prototxt(self, pb_file):
        with open(pb_file) as f:
            data = json.load(f)
        for k, v in data.items():
            setattr(self, k, v)

    def __repr__(self):
        return json.dumps(self.to_dict(), indent=2, default=str)
