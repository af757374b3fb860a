"""Global flags (counterpart of paddle_tpu/flags.py; reference:
platform/flags.cc + pybind/global_value_getter_setter.cc:338, surfaced as
paddle.get_flags/set_flags).

The same names, defaults and environment overrides as the JAX package
(an environment variable named like a flag overrides its default at
import, gflags style). What setting a flag does:

- framework knobs the port acts on:
  - `FLAGS_fault_injection_spec` installs the process-global fault plan
    (utils/fault_injection.py) that the checkpoint kill points and the
    resilient trainer share;
  - `FLAGS_ckpt_integrity_check`, `FLAGS_step_watchdog_timeout` are read
    by checkpoint.py and distributed/resilient.py;
- flags whose JAX effect is an XLA or jax.config setting take the
  nearest torch setting:
  - `FLAGS_check_nan_inf` (jax_debug_nans) turns on autograd's anomaly
    mode (`torch.autograd.set_detect_anomaly`), which raises where a
    backward op makes a NaN;
  - `FLAGS_cudnn_deterministic` sets `torch.backends.cudnn.deterministic`;
- kept for introspection only (torch has no switch that is theirs alone,
  or the JAX package keeps them so too): the memory knobs, the
  communication knobs, the profiler knobs, `FLAGS_embedding_deterministic`
  (torch's only switch for the embedding backward is the process-wide
  `use_deterministic_algorithms`), `FLAGS_elastic_expiry_grace`,
  `FLAGS_scan_chunk` and `FLAGS_quant_allreduce`.
"""
from __future__ import annotations

import os
from typing import Dict, List, Union

_FLAGS: Dict[str, object] = {
    # functional sanitizer (platform/flags.cc:44)
    "FLAGS_check_nan_inf": False,
    # memory knobs: the caching allocator owns allocation; introspection
    "FLAGS_fraction_of_gpu_memory_to_use": 0.92,
    "FLAGS_allocator_strategy": "xla",
    "FLAGS_eager_delete_tensor_gb": 0.0,
    # numeric
    "FLAGS_cudnn_deterministic": False,
    "FLAGS_embedding_deterministic": False,
    # comm: accepted for parity
    "FLAGS_nccl_nrings": 1,
    "FLAGS_sync_nccl_allreduce": True,
    # profiler
    "FLAGS_enable_rpc_profiler": False,
    "FLAGS_selected_gpus": "",
    "FLAGS_selected_tpus": "",
    # resilient runtime (paddle_tpu_torch.distributed.resilient)
    "FLAGS_fault_injection_spec": "",       # PDTPU_FAULTS grammar
    "FLAGS_step_watchdog_timeout": 0.0,     # seconds; 0 disables
    "FLAGS_ckpt_integrity_check": True,     # verify manifests on restore
    "FLAGS_elastic_expiry_grace": 2,        # stale polls before relaunch
    # scan-fused runner: steps a chunk when DistributedStrategy.scan_steps
    # is left at 1; 0/1 = one step a dispatch
    "FLAGS_scan_chunk": 0,
    # quantized gradient collectives: opt in to blockwise int8 gradient
    # all-reduce when DistributedStrategy.quant_allreduce is left default
    "FLAGS_quant_allreduce": False,
}

# env-var overrides at import (gflags behavior)
for _k in list(_FLAGS):
    if _k in os.environ:
        v = os.environ[_k]
        cur = _FLAGS[_k]
        if isinstance(cur, bool):
            _FLAGS[_k] = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, (int, float)):
            _FLAGS[_k] = type(cur)(v)
        else:
            _FLAGS[_k] = v


def get_flags(flags: Union[str, List[str]]):
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for f in flags:
        if f not in _FLAGS:
            raise ValueError(f"unknown flag {f!r}")
        out[f] = _FLAGS[f]
    return out


def set_flags(flags: Dict[str, object]):
    for k, v in flags.items():
        if k not in _FLAGS:
            raise ValueError(f"unknown flag {k!r}")
        _FLAGS[k] = v
        if k == "FLAGS_fault_injection_spec":
            # install the schedule process-globally so CheckpointManager
            # kill points and ResilientTrainer share it
            from .utils import fault_injection
            fault_injection.set_global_plan(
                fault_injection.FaultPlan.from_spec(v) if v else None)
        elif k == "FLAGS_check_nan_inf":
            import torch
            torch.autograd.set_detect_anomaly(bool(v))
        elif k == "FLAGS_cudnn_deterministic":
            import torch
            torch.backends.cudnn.deterministic = bool(v)
