"""Online serving runtime (counterpart of paddle_tpu/serving): the
continuous micro-batching `BatchingEngine` over a predict callable, the
continuous-batching `LLMEngine` (`serving.llm`, with its multi-LoRA
`AdapterBank`), their supervision
(`EngineSupervisor`: hung-dispatch watchdog, typed `DispatchFailedError`,
circuit breaker) and the deterministic simulation harness (`sim`).

    clock = serving.SimClock()
    engine = serving.BatchingEngine(fn, serving.EngineConfig(), clock=clock)
    report = serving.replay(engine, serving.poisson_trace(...))

The HTTP server, the router and rolling deploys wait for the front-end
slice (ROADMAP item 7e).
"""
from .clock import Clock, MonotonicClock, SimClock  # noqa: F401
from .engine import (BatchingEngine, DeadlineExceededError,  # noqa: F401
                     EngineConfig, RejectedError)
from .metrics import (SLO_CLASSES, LLMMetrics,  # noqa: F401
                      ServingMetrics, parse_exposition)
from .supervisor import (DispatchFailedError, DispatchHungError,  # noqa: F401
                         EngineSupervisor)
from .sim import (Arrival, ReplayReport, poisson_trace,  # noqa: F401
                  replay, uniform_trace)
from . import llm  # noqa: F401
from .llm import (AdapterBank, AdapterError,  # noqa: F401
                  GenerationHandle, LLMEngine, LLMEngineConfig, PrefixCache,
                  SlotPagedKVPool, SlotsExhaustedError)
