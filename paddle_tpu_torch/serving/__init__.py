"""Online serving runtime (counterpart of paddle_tpu/serving): the
continuous micro-batching `BatchingEngine` over a predict callable, the
continuous-batching `LLMEngine` (`serving.llm`, with its multi-LoRA
`AdapterBank`), their supervision
(`EngineSupervisor`: hung-dispatch watchdog, typed `DispatchFailedError`,
circuit breaker), the deterministic simulation harness (`sim`), and the
front end: the HTTP `ServingServer`, the fleet `ReplicaRouter` over
`InProcessReplica`s (failover, quarantine, prefill/decode handoff) with
its HTTP face `RouterServer`, and the rolling-deploy
`DeploymentController`.

    clock = serving.SimClock()
    engine = serving.BatchingEngine(fn, serving.EngineConfig(), clock=clock)
    report = serving.replay(engine, serving.poisson_trace(...))

    server = serving.ServingServer(llm_engine=llm, port=8000).start()

`serve(model_path)` waits for the port's `inference/` (ROADMAP item 9).
"""
from .clock import Clock, MonotonicClock, SimClock  # noqa: F401
from .deploy import DeployConfig, DeploymentController  # noqa: F401
from .engine import (BatchingEngine, DeadlineExceededError,  # noqa: F401
                     EngineConfig, RejectedError)
from .metrics import (SLO_CLASSES, LLMMetrics, RouterMetrics,  # noqa: F401
                      ServingMetrics, parse_exposition)
from .supervisor import (DispatchFailedError, DispatchHungError,  # noqa: F401
                         EngineSupervisor)
from .sim import (Arrival, ReplayReport, poisson_trace,  # noqa: F401
                  replay, uniform_trace)
from .server import ServingServer, serve  # noqa: F401
from .router import (InProcessReplica, ReplicaRouter,  # noqa: F401
                     RouterConfig, RouterHandle, RouterServer)
from . import llm  # noqa: F401
from .llm import (AdapterBank, AdapterError,  # noqa: F401
                  GenerationHandle, LLMEngine, LLMEngineConfig, PrefixCache,
                  SlotPagedKVPool, SlotsExhaustedError, WeightSwapError)
