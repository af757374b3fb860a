"""paddle_tpu_torch.obs — end-to-end observability (counterpart of
paddle_tpu/obs):

- `trace` — per-request timelines (`traceparent` ingestion, phase spans
  that tile the request's latency, a bounded LRU timeline store);
- `flight_recorder` — the process-global black-box ring of structured
  fault and lifecycle events, dumped atomically on demand;
- `prom` — Prometheus text-exposition plumbing, the `pdtpu_train_*`
  training exporter and the opt-in MetricsServer;
- `goodput` — the shared `PhaseLedger` frame bookkeeping and the
  training goodput ledger, live MFU, the recompile sentinel, memory
  telemetry and OOM forensics;
- `serving_ledger` — the serving economics ledger (pump phase tiling,
  token efficiency, per-tenant and per-class device seconds) and the SLO
  burn-rate monitor;
- `flops` — the analytic FLOPs and peak-FLOPs helpers;
- `numerics` — the training numerics observatory: in-step grad, param
  and update-ratio telemetry, the culprit-named non-finite blame report,
  the loss-spike sentinel, and the shared non-finite census;
- `deploy_metrics` — the rolling-deploy controller's `pdtpu_deploy_*`
  families.

The JAX package's `compile_observatory` waits for ROADMAP §1 item 9.
Stdlib-only at import: serving and training both depend on this package,
never the other way around.
"""
from .deploy_metrics import DeployMetrics
from .flight_recorder import DUMP_DIR_ENV, FlightRecorder, flight_recorder
from .flops import (conv_train_flops_per_step, decode_flops_per_token,
                    decode_mfu, lora_decode_flops_per_token, peak_flops,
                    train_flops_per_step)
from .goodput import (PHASES, GoodputLedger, HBMTelemetry, PhaseLedger,
                      RecompileSentinel, oom_forensics)
from .numerics import (NumericsObservatory, all_finite, bracket_path,
                       current_numerics, nonfinite_count, nonfinite_total,
                       telemetry_groups)
from .prom import MetricsServer, PromBuilder, TrainingMetrics, parse_exposition
from .serving_ledger import (SERVING_LEDGER_PHASES, ServingLedger,
                             SLOBurnMonitor)
from .trace import (LLM_PHASES, SERVING_PHASES, RequestTrace, TimelineStore,
                    ingest_traceparent, new_request_id)

__all__ = [
    "DeployMetrics",
    "DUMP_DIR_ENV", "FlightRecorder", "flight_recorder",
    "conv_train_flops_per_step", "decode_flops_per_token", "decode_mfu",
    "lora_decode_flops_per_token", "peak_flops", "train_flops_per_step",
    "PHASES", "GoodputLedger", "HBMTelemetry", "PhaseLedger",
    "RecompileSentinel", "oom_forensics",
    "NumericsObservatory", "all_finite", "bracket_path", "current_numerics",
    "nonfinite_count", "nonfinite_total", "telemetry_groups",
    "SERVING_LEDGER_PHASES", "ServingLedger", "SLOBurnMonitor",
    "MetricsServer", "PromBuilder", "TrainingMetrics", "parse_exposition",
    "LLM_PHASES", "SERVING_PHASES", "RequestTrace", "TimelineStore",
    "ingest_traceparent", "new_request_id",
]
