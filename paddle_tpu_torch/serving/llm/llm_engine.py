"""Continuous-batching LLM decode engine over the slot-paged KV pool
(counterpart of paddle_tpu/serving/llm/llm_engine.py).

`submit()` a prompt, get a `GenerationHandle` that streams its tokens.
Every `pump()` runs ONE unified mixed step over all slots: each slot
contributes a fixed-width `[prefill_chunk]` row — a prompt chunk for a
prefilling request, `[last_tok, 0, ...]` for a decoding one, zeros for a
free slot — and the one call writes every row's KV stripe at its
position, runs ragged paged attention over the pool's block tables with
per-row lengths `pos + adv`, and selects each row's next token. Prompts
longer than `prefill_chunk` are prefilled chunk by chunk between decode
steps (chunked prefill), so a short request's TTFT is bounded by a
couple of chunk-wide steps; the step that lands a prompt's last chunk
emits its first token. Between steps the scheduler admits queued
requests into freed slots and retires rows on EOS, max tokens or
deadline.

Selection is greedy on fp32 logits unless a request carries
`SamplingParams` (`sampling.py`): a seed makes it a temperature / top-k /
top-p draw on the lane `(seed, stream index)` of JAX's threefry, and a
grammar masks every step to the tokens its DFA allows, as in the JAX
engine. Each token's log-probability (fp32 log-softmax of the raw logits
at the chosen token) streams beside it. At a shared `block_len` of 8 a
greedy stream equals the port's one-shot `generate()` on the CPU.

A step in which no active request samples or is constrained runs the
greedy selection alone: no threefry, no grammar bank. Otherwise the
step selects only what the engine consumes: the emission column adv-1
of every row, drawn on its lane `(seed, sample_offset + emitted)`, and
every column t of a speculative verify window, drawn on lane `(seed,
sample_offset + emitted + t)`. The JAX step selects all N x C columns;
each consumed column's lane and draw are the same, so the tokens are
too.

Prefix sharing, as in the JAX engine and on by default: admission looks
the prompt up in a per-tenant radix `PrefixCache`; matched full blocks
are attached (the slot's block table points at the donor's refcounted
pages), a matched partial block is copied-on-write into the slot's own
page, and only the rest of the prompt is prefilled. A finished prefill
is indexed at the step that lands its last chunk. Under slot pressure
the cache evicts least-recently-used pages nobody reads; with
`host_kv_bytes > 0` each evicted full block spills to a host-RAM LRU
(`HostKVPool`) and a later admission onboards it instead of prefilling.
`export_stream(rid)` hands a decoding stream's KV and sampling lane to
another engine, whose `submit(prompt + emitted, kv_row=, lane=)`
continues it with a one-token prefill.

Admission control keeps the JAX engine's vocabulary: three SLO-class
queues admitted in strict priority order and tenant-fair within a class
(`default_slo` for a request that names none), a bounded queue, an
optional per-tenant in-flight token quota (reason "tenant_quota", checked
first), an optional engine-wide token budget `max_inflight_tokens`: a
full queue or an exhausted budget sheds the newest queued request of a
lower class ("shed") before it rejects ("queue_full" / "token_budget"),
every overload reject carrying `retry_after_s`; brownout (queue depth at
`brownout_queue_depth` caps admitted `max_new_tokens` at
`brownout_max_new_tokens` until the depth falls to half); absolute
deadlines (queued requests are dropped, active rows evicted, both with
`DeadlineExceededError`), and a graceful `stop(drain=True)`.

Supervision, as in the JAX engine: every step attempt runs through an
`EngineSupervisor` (serving/supervisor.py) and the fault plan's
`dispatch_*` / `poison_request` clauses, keyed on `_dispatch_idx` (one
per whole-step attempt, one per blame probe) and each request's
`submit_idx`. A failed step is retried whole `dispatch_retries` times;
then each active row is probed alone and the rows whose probe fails are
quarantined (`DispatchFailedError`, reason "poisoned"); a failure no
single row explains fails every active row (reason "engine") and charges
the circuit breaker, which at `breaker_threshold` stops admission and
flushes the queues with `RejectedError("circuit_open")`.

The JAX step is functional: a failed or abandoned attempt never changes
the slabs. Here each layer writes its KV stripe into the slabs in place
(`ops/attention.py` `update_kv_cache`), so three hazards are handled:

1. A raised attempt may have written some layers' stripes. Every write
   of a step lands at its rows' own positions pos..pos+C-1 (a row's slab
   row, never another's); the retry has the same toks, pos and committed
   KV below pos (the pool's lengths and the streams are committed only
   after a successful attempt), so it writes the same values over the
   same positions before anything reads them.
2. A blame probe runs the step with one real row. The JAX probe masks
   the others to (toks=0, pos=0, adv=0), which here would write token
   0's stripe over positions 0..C-1 of every survivor. The port masks
   them as it masks a free slot, pos = capacity: their writes land in
   the slab's pad region, which no block table addresses. The probed
   row writes its own positions with the values the full step writes.
3. An attempt the watchdog abandons keeps running on its deadline
   thread, and may wake after the engine has retried, committed and
   moved on, to write an old stripe over positions later steps filled.
   Each attempt therefore carries a write token (`_WriteFence`), and
   `update_kv_cache` enters the current thread's token around the
   enqueue of every write: under the token's lock, which is held only
   for that enqueue and never across a wait, it checks that the token
   is live, else raises `_AttemptRevoked`. The engine revokes an
   attempt's token (under the same lock) as soon as it stops waiting
   for it, before any retry is built, so once `revoke()` returns no
   write of that attempt can be issued. A write enqueued before the
   revocation runs on the same CUDA stream as the retry's launches
   (the attempt runs on the stream that was current on the engine
   thread, which it carries to its deadline thread), so it executes
   ahead of the retry's writes and writes the values the retry writes
   again (hazard 1). On the CPU each write completes inside the lock.
   A hang inside a CUDA wait holds no token lock, so it never blocks a
   revocation. `tests/test_torch_llm_supervision.py` holds this with a
   really abandoned attempt, and shows that without the check the
   abandoned write corrupts committed KV.

The attempt's operands (the device toks, pos and lengths, the block
table, the sampling operands) are built on the engine thread before the
attempt; the attempt touches only them, the model and the slabs, and
carries its own `torch.no_grad` and CUDA stream (both are per thread).

Observability, as in the JAX engine. `submit(trace=True)` keeps a
request timeline (`obs/trace.py`) on the handle (`handle.trace`,
`handle.timeline()`): submitted, admitted, the prefix lookup and KV
uploads, each prefill chunk, the first token, each decode step, and the
outcome; every terminal path concludes it once, into `timelines` (the
last `trace_buffer`). `economics=True` arms a `ServingLedger` and an
`SLOBurnMonitor` (`obs/serving_ledger.py`, attached to the metrics as
`ledger` and `burn`): each pump pass runs inside the ledger's
``measure("host")`` frame; each successful step's span, from before its
first launch to the readback of its tokens, is booked to
`prefill_compute` and `decode_compute` by advanced positions and
apportioned to the rows' tenants and SLO classes; the sampling operands,
the host tier's spills and uploads are booked as their own host phases;
retried, probed and abandoned attempts are not booked. Each request's
TTFT against `slo_ttft_target_ms`, and every shed, deadline expiry and
engine failure, is an outcome for the burn monitor. Disarmed, each hook
is one predicate. Because the port launches op by op, the booked span
holds the host's enqueue time (serving_ledger.py says more).

Multi-LoRA serving, as in the JAX engine: `max_adapters > 0` arms an
`AdapterBank` (`lora.py`) of that many rows of rank `lora_rank` beside
the all-zero row 0. `submit(adapter=)` names a loaded adapter (typed
rejects "adapter_unavailable", "unknown_adapter"); admission binds the
slot's bank row, and every step passes the bank's operand to the model,
whose gathered delta adds each row's own adapter, so base and adapter
streams share one step. `register_adapter` loads or hot-swaps a row (its
rollback token is the prior row), `rollback_adapter` restores one,
`unregister_adapter` refuses while a stream uses the adapter
("adapter_in_use"). Prefix KV is namespaced by (tenant, adapter), and a
swap flushes only that adapter's namespaces. `canary_probe(adapter=)`
greedy-decodes a golden prompt through a row on the contiguous cache,
checking that every logit is finite: the gate of a hot swap.

A swap from another thread must not tear a step. The JAX bank rewrites
rows functionally, so each jitted dispatch sees one bank; the port's
step launches layer by layer, so a row written in place between two
layers would give the step old rows below and new rows above. The bank
therefore writes copy-on-write under its lock (it replaces each touched
layer/site tensor and never writes one it has handed out), and the step
takes the bank's operand once, when `_step_args` builds its operands on
the engine thread: every layer of that attempt, an abandoned one
included, reads the tensors of one bank version, and the step after the
swap reads the new rows. `tests/test_torch_lora_engine.py` swaps from
another thread between two layers and holds every row of that step to
the all-old result.

Speculative decoding, as in the JAX engine: `LLMEngine(draft_model=)`
(a model of the target's vocabulary) arms a draft with its own
`SlotPagedKVPool` of the target's geometry and, with the prefix cache
on, its own page-congruent `PrefixCache(name="draft")`. Admission gives
every unconstrained request a draft row (an exhausted draft pool only
means that request runs without speculation). Each pump first runs the
draft phase: a chunk-wide catch-up replays the committed stream tokens
the draft has not seen, then a propose runs `spec_k + 1` width-1 draft
steps over every row past prefill whose draft is caught up, with at
least 2 tokens left and room for the window (a Python loop of forwards
on the draft's slabs; each step's selection stays on the device as the
next step's input, and the K drafts come back in one copy). The target
then scores each such row's window `[last_tok, d1..dK]` at adv = K+1 in
the one unified step, and the commit takes the longest draft prefix
that equals the target's own per-position selection plus one
corrective token, truncated at EOS and max tokens: every stream equals
plain decode's, greedy or seeded-sampled (the draft proposes on the
lanes the verify draws on). Only the accepted length is committed; the
verify's rejected columns lie past it, and the draft pool gives back
its run-ahead with `rewind_length`. Draft dispatches announce kind
"draft" and are breaker-exempt: after a failed one each riding request
is probed alone, a blamed request loses only its draft (`spec_off`, its
draft row freed), and failures no request explains count a streak that
disables speculation engine-wide at `breaker_threshold`. The draft's
solo probe runs at the row's own committed draft length, where a real
propose writes (JAX probes at position 0, which here would overwrite
the row's committed draft KV), and each draft attempt carries its own
write token. An adapter row speculates with the base draft; its verify
carries its adapter.

Rolling weight deploys, as in the JAX engine: the engine serves
`config.weight_version` (`weight_version` after a swap), and
`replace_params(state, version)` swaps the model's weights between steps
when the engine is idle, after an exact check of the names, shapes,
dtypes and devices of `model.state_dict()`, flushing both prefix caches
(typed `WeightSwapError` otherwise). The JAX engine rebinds an immutable
params tree, and the deploy controller keeps the old tree as its rollback
token. Here the swap rebinds the model's parameters to the new tensors
(`load_state_dict(assign=True)`) and never copies into the old ones, so
`params`, read before a swap, still holds the prior tensors untouched and
a rollback that passes them back restores them bit for bit. An engine
therefore owns its model: two engines on one module would swap together.
`evacuate(reason)` fails every queued and active request of a drained
replica whose streams the router has already moved.

Under a `SimClock` the engine runs threadless and the harness calls
`pump()`; under the default `MonotonicClock`, `start()` runs the same
`pump()` on a scheduler thread.

Not ported yet (a ROADMAP item): the compile observatory.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
import uuid
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...obs.flight_recorder import flight_recorder
from ...obs.trace import RequestTrace, TimelineStore
from ...ops.attention import kv_write_guard
from ..clock import Clock, MonotonicClock, SimClock
from ..engine import DeadlineExceededError, RejectedError
from ..metrics import SLO_CLASSES, LLMMetrics
from ..supervisor import (DispatchFailedError,  # noqa: F401
                          DispatchHungError, EngineSupervisor)
from .host_kv import HostKVPool
from .kv_pool import SlotPagedKVPool, SlotsExhaustedError
from .lora import AdapterBank, AdapterError
from .prefix_cache import PrefixCache
from .sampling import (GREEDY, SamplingParams, SlotSamplingTable,
                       compile_grammar, select_next, select_rows)

_log = logging.getLogger("paddle_tpu_torch.serving.llm")


class WeightSwapError(ValueError):
    """`replace_params` refused a hot swap: the engine still holds work,
    or the new state's signature (names, shapes, dtypes, devices)
    differs from the serving model's."""


@dataclass
class LLMEngineConfig:
    num_slots: int = 4             # decode width == KV pool size
    block_len: int = 16            # tokens per accounting block
    n_blocks: int = 8              # blocks per slot (capacity = 128 tokens)
    max_queue_depth: int = 64      # pending-request cap (admission control)
    max_new_tokens: int = 32       # default per-request generation cap
    eos_token_id: Optional[int] = None   # per-request override wins
    default_deadline_ms: Optional[float] = None
    prefill_chunk: int = 16        # prompt tokens prefilled per step; also
    #                                the unified step's fixed row width
    drain_timeout_s: float = 60.0
    cache_dtype: Optional[object] = None  # pool slab dtype override
    # ---- overload control ----
    default_slo: str = "batch"     # SLO class when submit() names none
    max_inflight_tokens: Optional[int] = None  # token-budget admission:
    #                                  sum of (prompt + max_new_tokens) over
    #                                  queued + active requests (None: off)
    brownout_queue_depth: Optional[int] = None  # queued requests at/above
    #                                  this enter brownout (None: off);
    #                                  exits at half the threshold
    brownout_max_new_tokens: int = 8  # admission-time cap while browned out
    retry_after_s: float = 1.0     # backpressure hint on overload rejects
    # ---- supervision ----
    dispatch_timeout_s: Optional[float] = None  # hung-dispatch watchdog
    dispatch_retries: int = 2      # whole-step retries before blame/fail
    breaker_threshold: int = 3     # consecutive engine-level failures that
    #                                open the circuit breaker
    max_grammars: int = 8          # distinct compiled grammars the fixed-
    #                                shape DFA bank holds; a request needing
    #                                one more is rejected ("grammar_capacity")
    max_dfa_states: int = 128      # per-grammar token-DFA state ceiling
    # ---- prefix cache, tenants, host KV tier ----
    enable_prefix_cache: bool = True   # radix KV prefix sharing on admission
    default_tenant: str = "default"    # tenant when submit() names none
    tenant_max_inflight_tokens: Optional[int] = None  # per-tenant quota:
    #                                  sum of (prompt + max_new_tokens) over
    #                                  one tenant's queued + active requests
    #                                  (None: off); exceeding it is a typed
    #                                  "tenant_quota" reject, checked before
    #                                  shedding (shedding other tenants
    #                                  cannot relieve it)
    host_kv_bytes: int = 0         # host-RAM spill tier byte budget: > 0
    #                                keeps pages evicted under pressure in a
    #                                HostKVPool for onboarding at admission
    # ---- observability ----
    trace_buffer: int = 256        # finished request timelines kept in
    #                                `timelines` (bounded LRU)
    economics: bool = False        # arm the ServingLedger + SLOBurnMonitor;
    #                                off = one predicate a hook, no clock
    #                                reads
    slo_burn_budget: float = 0.05       # error budget (bad-outcome share)
    slo_burn_threshold: float = 14.4    # fire when burn >= this multiple
    slo_burn_fast_window_s: float = 60.0
    slo_burn_slow_window_s: float = 300.0
    slo_burn_min_events: int = 10       # cold-start floor a window
    slo_burn_capture_s: float = 0.0     # > 0: bounded profiler capture
    slo_ttft_target_ms: Optional[Dict[str, float]] = None  # per-class TTFT
    #                                targets feeding the burn monitor; a
    #                                class absent from the dict counts every
    #                                prefill as a good outcome
    # ---- multi-LoRA serving ----
    max_adapters: int = 0          # > 0 arms the AdapterBank: that many
    #                                hot-swappable LoRA rows ride every
    #                                step through a per-slot adapter_idx
    #                                lane (row 0 is the all-zero base
    #                                pass-through, so adapter=None streams
    #                                stay bit-equal); 0 = no bank, and the
    #                                step is the pre-LoRA engine's
    lora_rank: int = 8             # bank row rank, fixed at construction;
    #                                loading an adapter of another rank is
    #                                a typed refusal
    lora_alpha: Optional[float] = None  # default scaling numerator for
    #                                rows loaded without an explicit alpha
    #                                (None = 2 * lora_rank)
    # ---- rolling weight deployment ----
    weight_version: str = "v0"     # version id of the weights the engine
    #                                starts on; replace_params() advances it
    # ---- speculative decoding ----
    spec_k: int = 4                # draft tokens proposed a verify window
    #                                (read only by an engine built with a
    #                                draft_model, which then requires
    #                                spec_k + 1 <= prefill_chunk: the
    #                                window rides one unified-step row)

    def __post_init__(self):
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {self.num_slots}")
        if self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {self.max_queue_depth}")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.default_slo not in SLO_CLASSES:
            raise ValueError(
                f"default_slo must be one of {SLO_CLASSES}, got "
                f"{self.default_slo!r}")
        if self.brownout_max_new_tokens < 1:
            raise ValueError(
                f"brownout_max_new_tokens must be >= 1, got "
                f"{self.brownout_max_new_tokens}")
        if self.dispatch_retries < 0:
            raise ValueError("retry counts must be >= 0")
        if self.breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got "
                f"{self.breaker_threshold}")
        if self.max_grammars < 1:
            raise ValueError(
                f"max_grammars must be >= 1, got {self.max_grammars}")
        if self.max_dfa_states < 1:
            raise ValueError(
                f"max_dfa_states must be >= 1, got {self.max_dfa_states}")
        if not self.default_tenant:
            raise ValueError("default_tenant must be a non-empty string")
        if (self.tenant_max_inflight_tokens is not None
                and self.tenant_max_inflight_tokens < 1):
            raise ValueError(
                f"tenant_max_inflight_tokens must be >= 1, got "
                f"{self.tenant_max_inflight_tokens}")
        if self.host_kv_bytes < 0:
            raise ValueError(
                f"host_kv_bytes must be >= 0, got {self.host_kv_bytes}")
        if self.trace_buffer < 1:
            raise ValueError(
                f"trace_buffer must be >= 1, got {self.trace_buffer}")
        if not 0.0 < self.slo_burn_budget <= 1.0:
            raise ValueError(
                f"slo_burn_budget must be in (0, 1], got "
                f"{self.slo_burn_budget}")
        if self.slo_burn_threshold <= 0:
            raise ValueError(
                f"slo_burn_threshold must be > 0, got "
                f"{self.slo_burn_threshold}")
        if not (0.0 < self.slo_burn_fast_window_s
                <= self.slo_burn_slow_window_s):
            raise ValueError(
                "slo_burn windows must satisfy 0 < fast <= slow, got "
                f"fast={self.slo_burn_fast_window_s} "
                f"slow={self.slo_burn_slow_window_s}")
        if self.slo_burn_min_events < 1:
            raise ValueError(
                f"slo_burn_min_events must be >= 1, got "
                f"{self.slo_burn_min_events}")
        if self.max_adapters < 0:
            raise ValueError(
                f"max_adapters must be >= 0, got {self.max_adapters}")
        if self.lora_rank < 1:
            raise ValueError(
                f"lora_rank must be >= 1, got {self.lora_rank}")
        if self.lora_alpha is not None and self.lora_alpha <= 0:
            raise ValueError(
                f"lora_alpha must be > 0, got {self.lora_alpha}")
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        if self.slo_ttft_target_ms is not None:
            for cls, target in self.slo_ttft_target_ms.items():
                if cls not in SLO_CLASSES:
                    raise ValueError(
                        f"slo_ttft_target_ms keys must be SLO classes "
                        f"{SLO_CLASSES}, got {cls!r}")
                if target <= 0:
                    raise ValueError(
                        f"slo_ttft_target_ms[{cls!r}] must be > 0, got "
                        f"{target}")


class GenerationHandle:
    """Per-request streaming view + completion future. Tokens stream into
    `tokens_so_far()` as steps retire them; `future` resolves with the
    np.int32 array of generated tokens, or with DeadlineExceededError /
    RejectedError / the step's error on eviction (partial tokens stay
    readable either way)."""

    def __init__(self, prompt_len: int, max_new_tokens: int,
                 slo: str = "batch"):
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.slo = slo
        self.future: Future = Future()
        self.ttft_ms: Optional[float] = None
        self.rid: Optional[str] = None       # request id (always assigned)
        self.trace: Optional[RequestTrace] = None   # submit(trace=True)
        self._lock = threading.Lock()
        self._tokens: List[int] = []
        self._logprobs: List[Optional[float]] = []

    def _append(self, tok: int, lp: Optional[float] = None):
        with self._lock:
            self._tokens.append(int(tok))
            self._logprobs.append(None if lp is None else float(lp))

    def tokens_so_far(self) -> List[int]:
        with self._lock:
            return list(self._tokens)

    def logprobs_so_far(self) -> List[Optional[float]]:
        """Per-token log-probabilities (None unless submit(logprobs=True))."""
        with self._lock:
            return list(self._logprobs)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        return self.future.result(timeout)

    def timeline(self) -> Optional[dict]:
        """The request's timeline when it was traced (complete once the
        future has resolved), else None."""
        return self.trace.to_dict() if self.trace is not None else None


class _GenRequest:
    __slots__ = ("prompt", "max_new_tokens", "eos_token_id", "arrival",
                 "deadline", "handle", "slot", "emitted", "last_tok", "slo",
                 "cost", "chunk_off", "tenant", "attached_pages", "rid",
                 "want_logprobs", "sampling", "sample_offset", "gid",
                 "dfa_state0", "kv_row", "submit_idx", "trace", "adapter",
                 "draft_slot", "spec_off", "draft_attached")

    def __init__(self, prompt, max_new_tokens, eos_token_id, arrival,
                 deadline, slo, submit_idx=0, want_logprobs=False,
                 tenant="default"):
        self.prompt = prompt              # np.int32 [S]
        self.max_new_tokens = max_new_tokens
        self.eos_token_id = eos_token_id
        self.arrival = arrival            # clock seconds
        self.deadline = deadline          # absolute clock seconds or None
        self.slo = slo
        self.submit_idx = submit_idx      # lifetime admission index (fault
        #                                   injection keys poison on this)
        self.cost = len(prompt) + max_new_tokens  # token-budget estimate
        self.handle = GenerationHandle(len(prompt), max_new_tokens, slo)
        self.slot: Optional[int] = None
        self.emitted: List[int] = []
        self.last_tok: int = 0
        self.chunk_off: int = 0           # prompt tokens already prefilled,
        #                                   or attached / COW'd / onboarded /
        #                                   imported at admission
        self.tenant = tenant
        self.attached_pages: List[int] = []   # shared pages this request
        #                                       reads (refcounted in pool)
        self.rid: Optional[str] = None    # request id (always assigned)
        self.kv_row: Optional[dict] = None  # KV of the prompt's first
        #                                   `length` tokens from another
        #                                   engine's export_stream
        self.want_logprobs = want_logprobs
        self.sampling: Optional[SamplingParams] = None
        self.sample_offset: int = 0       # stream index of the first token
        #                                   this admission emits
        self.gid: int = 0                 # grammar bank row (0: none)
        self.dfa_state0: int = 0          # DFA state at admission
        self.trace: Optional[RequestTrace] = None   # None unless traced
        self.adapter: Optional[str] = None    # AdapterBank id the stream
        #                                       decodes under (None: base)
        self.draft_slot: Optional[int] = None  # row in the draft pool (None:
        #                                       no draft, or none was free)
        self.spec_off: bool = False       # draft quarantined: the stream
        #                                   continues as plain decode
        self.draft_attached: List[int] = []   # shared draft-pool pages this
        #                                       request reads


def _current_stream(dev: torch.device):
    """The CUDA stream current on the calling thread for `dev` (None on
    the CPU): an attempt runs on the engine thread's stream wherever it
    runs."""
    return torch.cuda.current_stream(dev) if dev.type == "cuda" else None


class _AttemptRevoked(RuntimeError):
    """A KV write of a step attempt the engine had already revoked (the
    watchdog abandoned it): the attempt stops at its next write."""


class _WriteFence:
    """The KV write token of one supervised step attempt (the module
    docstring gives the argument). `update_kv_cache` enters it around the
    enqueue of each write: the lock is held for that enqueue alone, and
    `check` refuses a revoked token. `revoke()` takes the same lock, so
    once it returns no write of the attempt can be issued; a refusal is
    kept in `error` and signalled on `stopped`."""

    __slots__ = ("_lock", "revoked", "error", "stopped")

    def __init__(self):
        self._lock = threading.Lock()
        self.revoked = False
        self.error: Optional[BaseException] = None
        self.stopped = threading.Event()

    def check(self):
        if self.revoked:
            self.error = _AttemptRevoked(
                "KV write refused: the engine revoked this step attempt "
                "after its watchdog abandoned it")
            flight_recorder().record("kv_write_fenced", engine="llm")
            self.stopped.set()
            raise self.error

    def __enter__(self):
        self._lock.acquire()
        try:
            self.check()
        except BaseException:
            self._lock.release()
            raise
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False

    def revoke(self):
        with self._lock:
            self.revoked = True


class _StepArgs:
    """The operands of one unified step (or blame probe), built on the
    engine thread before the attempt: host rows (`toks`, `pos`, `adv`,
    `verify` the rows carrying a speculative window, and for a sampled
    step `ctr` and `constrained`), their device copies, the lengths, the
    block table and the slabs, and for a sampled step the sampling
    operands of the selected positions (`sel_row`, `sel_col` on the host,
    their flat indices `rows` on the device); `adapters` the adapter
    bank's operand (None unless armed), taken once here so every layer of
    the attempt reads one bank version; `stream` is the CUDA stream
    current on the engine thread (None on the CPU), `mask_ms` the host
    time the sampling operands took, and `mask_s` the same on the
    engine's clock (None unless the ledger is armed)."""

    __slots__ = ("toks", "pos", "adv", "toks_d", "pos_d", "seq_lens",
                 "table", "slabs", "sampled", "ctr", "constrained", "keys",
                 "params", "bank", "rows", "stream", "mask_ms",
                 "mask_s", "adapters", "verify", "sel_row", "sel_col")


class _DraftArgs:
    """The operands of one draft attempt, built on the engine thread
    before it. A catch-up: `toks_d [N, C]`, `pos_d [N]`, `seq_lens [N]`.
    A propose: `toks_d [N]` (each row's first input token), `pos_d` and
    `seq_lens` [K+1, N] (step j writes at pos + j*act and attends to
    pos + (j+1)*act), and when a row samples `params` (temperature,
    top_k, top_p, do_sample) and `keys [K, N, 2]`, step j's lane keys
    (step K selects nothing). Both
    carry the draft pool's block table and slabs and the engine thread's
    CUDA stream."""

    __slots__ = ("toks_d", "pos_d", "seq_lens", "table", "slabs", "stream",
                 "params", "keys")


class LLMEngine:
    """The model must implement `init_cache` / `forward_with_cache` (e.g.
    `models.gpt.GPTForCausalLM`, `models.llama.LlamaForCausalLM`); it is
    switched to eval mode. `fault_plan` (None: the env-driven
    `global_plan()`) injects dispatch faults; `on_break` is called once
    when the circuit breaker opens. `draft_model`, a model of the same
    vocabulary on the same device (the target itself will do), arms
    speculative decoding with `config.spec_k` drafts a window."""

    def __init__(self, model, config: Optional[LLMEngineConfig] = None,
                 clock: Optional[Clock] = None,
                 metrics: Optional[LLMMetrics] = None, fault_plan=None,
                 on_break=None, draft_model=None):
        self.model = model
        model.eval()
        self.config = config or LLMEngineConfig()
        self.clock = clock or MonotonicClock()
        self.metrics = metrics or LLMMetrics()
        if not self.config.weight_version:
            raise ValueError("weight_version must be a non-empty string")
        self.weight_version = self.config.weight_version
        # pad_tokens=prefill_chunk: the fixed-width KV stripe written at a
        # row's position needs chunk-width scratch past the last
        # addressable block, so near-capacity writes never clamp back onto
        # valid KV (block tables never point into the pad region)
        self.pool = SlotPagedKVPool(
            model.init_cache, self.config.num_slots, self.config.block_len,
            self.config.n_blocks, dtype=self.config.cache_dtype,
            pad_tokens=self.config.prefill_chunk)
        self.metrics.set_slots(0, self.pool.num_slots)
        # the host spill tier under the prefix cache, which wires itself as
        # the pool's on_pressure hook
        self.host_kv: Optional[HostKVPool] = (
            HostKVPool(self.config.host_kv_bytes, self.config.block_len)
            if self.config.host_kv_bytes > 0 else None)
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.pool, host_pool=self.host_kv,
                        clock=self.clock.now)
            if self.config.enable_prefix_cache else None)
        # per-slot sampling + grammar bank, sized off the model's vocab
        vocab_size = int(getattr(getattr(model, "config", None),
                                 "vocab_size", 0))
        if vocab_size < 1:
            raise ValueError(
                "model must expose config.vocab_size for the sampling "
                "subsystem's grammar mask")
        self.sampling_table = SlotSamplingTable(
            self.config.num_slots, vocab_size,
            max_grammars=self.config.max_grammars,
            max_dfa_states=self.config.max_dfa_states,
            device=self.pool.device)
        # the multi-LoRA bank: K stacked adapter trees and a per-slot row
        # lane passed to every step; None unless armed, and then every
        # step is the pre-LoRA engine's
        self.adapter_bank: Optional[AdapterBank] = None
        if self.config.max_adapters > 0:
            self.adapter_bank = AdapterBank(
                model, self.config.max_adapters, self.config.lora_rank,
                self.config.num_slots,
                default_alpha=self.config.lora_alpha)
        # speculative decoding: the draft's own pool (the target's
        # geometry, so both prefix caches attach page-congruent spans)
        # and the engine-wide state of its failure protocol
        self.draft_model = draft_model
        self.draft_pool: Optional[SlotPagedKVPool] = None
        self.draft_prefix_cache: Optional[PrefixCache] = None
        self._spec_disabled = False     # engine-wide draft kill switch
        self._draft_failstreak = 0      # consecutive draft failures no
        #                                 request explains (breaker-exempt)
        self.spec_windows = 0           # lifetime verify windows committed
        self.spec_drafted = 0           # lifetime draft tokens verified
        self.spec_accepted = 0          # lifetime draft tokens accepted
        if draft_model is not None:
            if self.config.spec_k + 1 > self.config.prefill_chunk:
                raise ValueError(
                    f"spec_k + 1 ({self.config.spec_k + 1}) exceeds the "
                    f"unified step width prefill_chunk "
                    f"({self.config.prefill_chunk}): the verify window "
                    "must fit one step row")
            draft_vocab = int(getattr(getattr(draft_model, "config", None),
                                      "vocab_size", 0))
            if draft_vocab != vocab_size:
                raise ValueError(
                    f"draft vocab_size {draft_vocab} differs from the "
                    f"target's {vocab_size}")
            draft_model.eval()
            self.draft_pool = SlotPagedKVPool(
                draft_model.init_cache, self.config.num_slots,
                self.config.block_len, self.config.n_blocks,
                dtype=self.config.cache_dtype,
                pad_tokens=self.config.prefill_chunk)
            if self.draft_pool.device != self.pool.device:
                raise ValueError(
                    f"draft model on {self.draft_pool.device}, target on "
                    f"{self.pool.device}")
            if self.config.enable_prefix_cache:
                self.draft_prefix_cache = PrefixCache(self.draft_pool,
                                                      name="draft")
        self._queues: Dict[str, deque] = {c: deque() for c in SLO_CLASSES}
        self._active: Dict[int, _GenRequest] = {}   # slot -> request
        self._cond = threading.Condition()
        self._draining = False
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self.decode_iterations = 0   # lifetime steps carrying >=1 decode row
        self.prefill_dispatches = 0  # lifetime steps carrying only prefill
        self.prefill_tokens = 0      # lifetime prompt tokens prefilled
        self.steps = 0               # lifetime unified steps run
        self.host_onboard_tokens = 0  # prompt tokens onboarded from the
        #                               host tier (prefill skipped)
        self.kv_import_tokens = 0    # prompt tokens imported from a
        #                              kv_row (prefill skipped)
        self._brownout = False
        self._submit_idx = 0         # lifetime admissions (poison keying)
        self._dispatch_idx = 0       # lifetime dispatch attempts (fault
        #                              clauses key on this index)
        # the write tokens of attempts that ended hung (the watchdog
        # abandoned them, or an injected hang), newest last
        self.abandoned_attempts: deque = deque(maxlen=64)
        # finished request timelines (bounded LRU)
        self.timelines = TimelineStore(self.config.trace_buffer)
        # serving economics: both None unless armed, so every hook costs
        # one predicate when disabled
        self.ledger = None
        self.burn = None
        self._spill_booked = 0.0     # spill seconds already booked
        if self.config.economics:
            from ...obs.serving_ledger import ServingLedger, SLOBurnMonitor
            self.ledger = ServingLedger(clock=self.clock.now)
            self.burn = SLOBurnMonitor(
                clock=self.clock.now,
                budget=self.config.slo_burn_budget,
                threshold=self.config.slo_burn_threshold,
                fast_window_s=self.config.slo_burn_fast_window_s,
                slow_window_s=self.config.slo_burn_slow_window_s,
                min_events=self.config.slo_burn_min_events,
                capture_s=self.config.slo_burn_capture_s)
        self.metrics.ledger = self.ledger
        self.metrics.burn = self.burn
        if fault_plan is None:
            from ...utils.fault_injection import global_plan
            fault_plan = global_plan()
        self._fault_plan = fault_plan
        self.on_break = on_break
        self.supervisor = EngineSupervisor(
            dispatch_timeout_s=self.config.dispatch_timeout_s,
            breaker_threshold=self.config.breaker_threshold,
            on_trip=self._on_breaker_trip, name="llm")

    # ---- the unified step ----
    def _step_args(self, toks: np.ndarray, pos: np.ndarray, adv: np.ndarray,
                   ctr: Optional[np.ndarray] = None,
                   constrained: bool = False,
                   adapter_rows: Optional[np.ndarray] = None,
                   verify: Optional[np.ndarray] = None) -> _StepArgs:
        """The operands of one step over every slot, on the pool's device.
        `toks [N, C]` carries each slot's chunk, `pos [N]` its committed
        length (the write offset), `adv [N]` how many of the C columns are
        real; `verify [N]` (bool) marks the rows carrying a speculative
        window, whose every column 0..adv-1 is consumed. With `ctr` (each
        row's stream index at its emission column, at column 0 for a
        verify row) the step samples: the lane keys, per-slot params, the
        selected positions (each row's emission column, every column of a
        verify window), and the grammar bank when a row is `constrained`.
        An armed engine adds the bank's operand: the slots' bound rows, or
        `adapter_rows` (a bank row a batch row) for a probe. Call it on
        the engine thread, under the engine lock when the engine runs: it
        reads the pool's block table and the sampling table."""
        dev = self.pool.device
        a = _StepArgs()
        a.toks, a.pos, a.adv = toks, pos, adv
        a.verify = verify
        a.toks_d = torch.from_numpy(toks).to(dev)
        a.pos_d = torch.from_numpy(pos).to(dev)
        a.seq_lens = a.pos_d + torch.from_numpy(adv).to(dev)
        a.table = self.pool.device_block_table()
        a.slabs = self.pool.slabs
        a.stream = _current_stream(dev)
        a.sampled = ctr is not None
        a.ctr, a.constrained = ctr, constrained
        a.keys = a.params = a.bank = a.rows = a.mask_ms = a.mask_s = None
        a.adapters = a.sel_row = a.sel_col = None
        if self.adapter_bank is not None:
            a.adapters = (self.adapter_bank.device_args()
                          if adapter_rows is None else
                          self.adapter_bank.args_for_rows(adapter_rows))
        if a.sampled:
            t0 = time.perf_counter()
            tl0 = self.clock.now() if self.ledger is not None else None
            tab = self.sampling_table
            N, C = toks.shape
            # each row's emission column adv-1 on lane ctr; a verify row's
            # columns 0..adv-1, column t on lane ctr + t
            win = np.zeros(N, bool) if verify is None else verify
            width = np.where(win, adv, 1)
            a.sel_row = np.repeat(np.arange(N), width)
            t = (np.arange(a.sel_row.size)
                 - np.repeat(np.cumsum(width) - width, width))
            w = win[a.sel_row]
            a.sel_col = np.where(w, t, np.maximum(adv - 1, 0)[a.sel_row])
            idx = ctr[a.sel_row] + np.where(w, t, 0).astype(ctr.dtype)
            a.keys = tab.lane_keys(idx, rows=a.sel_row)
            a.params = tab.device_args()
            if a.sel_row.size != N:
                r = torch.from_numpy(a.sel_row).to(dev)
                a.params = tuple(p.index_select(0, r) for p in a.params)
            a.bank = tab.device_bank() if constrained else None
            a.rows = torch.from_numpy(a.sel_row * C + a.sel_col).to(dev)
            a.mask_ms = (time.perf_counter() - t0) * 1e3
            if tl0 is not None:
                a.mask_s = self.clock.now() - tl0
        return a

    @torch.no_grad()
    def _step_logits(self, a: _StepArgs) -> torch.Tensor:
        """The model half of one mixed prefill/decode step: KV stripes
        land in the slabs in place; attention masks every row to
        `col <= pos+t` and `col < pos+adv`. Returns the logits [N, C, V]
        on the pool's device."""
        paged = (a.table, a.seq_lens, self.pool.block_len,
                 self.pool.n_blocks)
        logits, _ = self.model.forward_with_cache(
            a.toks_d, a.slabs, a.pos_d, paged=paged, adapters=a.adapters)
        return logits

    @torch.no_grad()
    def _run_step(self, a: _StepArgs):
        """`_step_logits` plus greedy selection: the per-position tokens
        and their fp32 log-probabilities, both [N, C] numpy, in one copy
        back."""
        lf = self._step_logits(a).float()
        sel = torch.argmax(lf, dim=-1)
        lp = torch.log_softmax(lf, dim=-1).gather(-1, sel[..., None])[..., 0]
        out = torch.stack([sel.to(torch.int32),
                           lp.view(torch.int32)]).cpu().numpy()
        return out[0], out[1].view(np.float32)

    @torch.no_grad()
    def _run_sampled_step(self, a: _StepArgs):
        """`_step_logits` plus per-slot selection of the positions the
        engine consumes (`select_rows` over `a.rows`: each row's emission
        column, every column of a verify window): ([N, C] tokens, [N, C]
        fp32 log-probabilities of the raw logits, both 0 at unselected
        positions, [N] DFA states after each row's last selected token),
        numpy. Selected position i draws on lane key `a.keys[i]`."""
        temp, topk, topp, samp, dstate, gid = a.params
        lg = self._step_logits(a)
        N, C = a.toks.shape
        lf = lg.reshape(N * C, lg.shape[-1])[a.rows].float()
        sel, new_state = select_rows(lf, a.keys, temp, topk, topp, samp,
                                     dstate, gid, a.bank)
        lp = torch.log_softmax(lf, dim=-1).gather(
            -1, sel[:, None].long())[:, 0]
        # one copy back: tokens, logprob bits, states
        out = torch.stack([sel, lp.view(torch.int32),
                           new_state.to(torch.int32)]).cpu().numpy()
        nxt = np.zeros((N, C), np.int32)
        lps = np.zeros((N, C), np.float32)
        nxt[a.sel_row, a.sel_col] = out[0]
        lps[a.sel_row, a.sel_col] = out[1].view(np.float32)
        states = np.zeros((N,), np.int32)
        states[a.sel_row] = out[2]
        return nxt, lps, states

    def _attempt(self, a: _StepArgs):
        """The callable of one supervised attempt over `a`: given its
        write token, it runs the step with the token guarding every KV
        write, under no_grad and on the engine thread's CUDA stream (both
        per thread, and the attempt may run on a deadline thread).
        Returns ([N, C] tokens, [N, C] logprobs, [N] DFA states or None
        for a greedy step)."""
        def run(fence: _WriteFence):
            stream = (torch.cuda.stream(a.stream) if a.stream is not None
                      else contextlib.nullcontext())
            with torch.no_grad(), stream, kv_write_guard(fence):
                if a.sampled:
                    return self._run_sampled_step(a)
                return self._run_step(a) + (None,)
        return run

    # ---- supervised dispatch ----
    def _run_dispatch(self, kinds, fn, exempt: bool = False):
        """One supervised attempt of `fn(fence)`. Every attempt, retries
        and blame probes included, consumes a dispatch index, which is
        what the fault clauses key on. `kinds` is the ordered (kind,
        submit indices) pairs riding it: prefill rows announce first,
        then decode rows, both at the same index; a draft attempt
        announces kind "draft", so a fault plan can poison only a
        request's draft. `exempt=True` (the draft's attempts) keeps the
        failure out of the supervisor's dispatch-failure stat, which the
        breaker's accounting reads. The attempt's write token is revoked
        as soon as the engine stops waiting for it; the token of an
        attempt that ended hung is kept in `abandoned_attempts`."""
        idx = self._dispatch_idx
        self._dispatch_idx += 1
        plan = self._fault_plan
        label = "+".join(k for k, _ in kinds) or "step"
        fence = _WriteFence()

        def guarded():
            if plan is not None:
                for kind, rids in kinds:
                    plan.maybe_dispatch_fault(idx, kind=kind,
                                              request_ids=rids)
            return fn(fence)

        try:
            return self.supervisor.run(guarded, label=label, exempt=exempt)
        except DispatchHungError:
            self.abandoned_attempts.append(fence)
            raise
        finally:
            fence.revoke()

    def _kinds_of(self, prefill_slots, decode_slots) -> Tuple:
        """(kind, request_ids) announcement order for fault injection:
        prefill rows first, then decode rows, both at one dispatch idx.
        Rows riding an adapter also announce kind "adapter" at the same
        index, so a `poison_request@rid:adapter` clause scopes a fault to
        one adapter's streams without touching their batch-mates."""
        kinds = []
        if prefill_slots:
            kinds.append(("prefill", tuple(sorted(
                self._active[s].submit_idx for s in prefill_slots))))
        if decode_slots:
            kinds.append(("decode", tuple(sorted(
                self._active[s].submit_idx for s in decode_slots))))
        adapter_rows = [s for s in list(prefill_slots) + list(decode_slots)
                        if self._active[s].adapter]
        if adapter_rows:
            kinds.append(("adapter", tuple(sorted(
                self._active[s].submit_idx for s in adapter_rows))))
        return tuple(kinds)

    # ---- lifecycle ----
    def start(self) -> "LLMEngine":
        """Run the scheduler on a background thread. Not for a SimClock:
        the harness calls pump() itself."""
        if isinstance(self.clock, SimClock):
            raise RuntimeError(
                "LLMEngine.start() with a SimClock would busy-spin: drive "
                "pump() from the simulation harness instead")
        with self._cond:
            if self._stopped:
                raise RuntimeError("engine already stopped")
            if self._thread is not None:
                return self
            self._thread = threading.Thread(
                target=self._scheduler_main, daemon=True,
                name="pdtt-llm-scheduler")
            self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        """Graceful drain: stop admissions, then finish every admitted
        sequence before stopping the scheduler. With drain=False, queued
        and decoding requests fail with RejectedError("shutdown"). A drain
        that cannot finish inside `timeout` (default
        config.drain_timeout_s) fails the stragglers with
        RejectedError("drain_timeout")."""
        with self._cond:
            if self._stopped:
                return
            self._draining = True
            flight_recorder().record(
                "drain_begin", engine="llm", drain=bool(drain),
                queued=self._queue_len_locked(), active=len(self._active))
            if not drain:
                self._reject_all_locked("shutdown", "engine shut down")
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            join_s = (timeout if timeout is not None
                      else self.config.drain_timeout_s)
            thread.join(join_s)
            if thread.is_alive():
                _log.warning("llm drain did not complete within %.1fs; "
                             "failing sequences still in flight", join_s)
        else:
            # threadless (sim) mode: run the scheduler inline, with a
            # no-progress guard so a pump that can no longer advance
            # anything (the breaker open mid-drain) falls through to the
            # stranded-future cleanup
            prev = None
            while True:
                with self._cond:
                    if not (self._queue_len_locked() or self._active):
                        break
                self.pump()
                state = (self._queue_len_locked(), len(self._active),
                         self._dispatch_idx)
                if state == prev:
                    break
                prev = state
        with self._cond:
            stranded = self._reject_all_locked("drain_timeout",
                                               "engine drain timed out")
            self._stopped = True
            self._cond.notify_all()
        flight_recorder().record("drain_end", engine="llm",
                                 stranded=stranded)

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def broken(self) -> bool:
        """Circuit breaker open: repeated engine-level dispatch failures;
        admissions reject with "circuit_open"."""
        return self.supervisor.open

    def _on_breaker_trip(self):
        """Repeated engine-level failures: admissions stop (submit ->
        "circuit_open"), queued requests fail now (their dispatches would
        only fail again), and `on_break` tells the front end, which
        drains on its own thread."""
        flushed = 0
        with self._cond:
            for q in self._queues.values():
                while q:
                    req = q.popleft()
                    self._conclude(req, "rejected:circuit_open")
                    req.handle.future.set_exception(RejectedError(
                        "engine circuit breaker open after repeated "
                        "dispatch failures", reason="circuit_open"))
                    self.metrics.on_reject("circuit_open")
                    flushed += 1
            self.metrics.set_queue_depth(0)
            self._cond.notify_all()
        flight_recorder().record("queue_flushed", engine="llm",
                                 reason="circuit_open", n=flushed)
        self.metrics.set_circuit_open(True)
        if self.on_break is not None:
            try:
                self.on_break()
            except Exception:
                _log.exception("on_break callback failed")

    # ---- rolling weight deployment ----
    def evacuate(self, reason: str = "deploy_drain") -> int:
        """Deploy-drain eviction: fail every queued and active request with
        a typed RejectedError(reason) and free their rows, without the
        terminal stop() path, so the engine serves on afterwards. The
        deploy controller calls it only after the router has re-queued
        those streams on a survivor, so their handles here are orphans.
        Returns the requests evicted."""
        with self._cond:
            n = self._reject_all_locked(reason,
                                        f"engine evacuated ({reason})")
            self._cond.notify_all()
        if n:
            flight_recorder().record("deploy_evacuate", engine="llm",
                                     reason=reason, n=n)
        return n

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The serving weights by `model.state_dict()` name: the tensors
        the model holds now, not copies. A caller that keeps the dict
        keeps those tensors alive and unchanged across a later
        `replace_params`, which rebinds the model to new tensors (the
        deploy controller's rollback token)."""
        return dict(self.model.state_dict())

    def replace_params(self, new_params, version: str):
        """Hot weight swap between steps. `new_params` maps every name of
        `model.state_dict()` to a tensor of the same shape, dtype and
        device; the model's parameters and buffers are rebound to those
        tensors (`load_state_dict(assign=True)`), so the tensors it held
        before are neither written nor freed while a caller keeps them.
        Refuses (typed `WeightSwapError`) another set of names, any leaf
        of another shape, dtype or device, or an engine holding queued or
        active work; the swap itself runs under the engine lock, so no
        step of this engine starts during it (an abandoned attempt's
        write token is already revoked). Flushes the prefix cache and the
        draft's: their KV was computed under the old weights."""
        if not version:
            raise ValueError("version must be a non-empty string")
        new = dict(new_params)
        old = self.model.state_dict()
        if set(new) != set(old):
            missing = sorted(set(old) - set(new))
            extra = sorted(set(new) - set(old))
            raise WeightSwapError(
                f"weight set {version!r} has a different tree structure "
                f"than the serving params (missing {missing[:4]}, "
                f"unexpected {extra[:4]})")
        for name, cur in old.items():
            x = new[name]
            if not torch.is_tensor(x):
                raise WeightSwapError(
                    f"weight set {version!r} leaf [{name!r}] is "
                    f"{type(x).__name__}, not a tensor")
            if (tuple(x.shape) != tuple(cur.shape) or x.dtype != cur.dtype
                    or x.device != cur.device):
                raise WeightSwapError(
                    f"weight set {version!r} leaf [{name!r}] is "
                    f"{tuple(x.shape)}/{x.dtype} on {x.device}, serving "
                    f"params have {tuple(cur.shape)}/{cur.dtype} on "
                    f"{cur.device}: the signature must match exactly "
                    "(a swap rebinds, it never casts or moves)")
        with self._cond:
            if self._queue_len_locked() or self._active:
                raise WeightSwapError(
                    f"cannot swap to {version!r} with work in flight "
                    f"(queued={self._queue_len_locked()}, "
                    f"active={len(self._active)}): drain first")
            flushed = 0
            if self.prefix_cache is not None:
                flushed = self.prefix_cache.clear()
            if self.draft_prefix_cache is not None:
                flushed += self.draft_prefix_cache.clear()
            prior = self.weight_version
            self.model.load_state_dict(new, strict=True, assign=True)
            self.weight_version = str(version)
            self._cond.notify_all()
        flight_recorder().record(
            "weight_swap", engine="llm", version=str(version),
            prior=prior, leaves=len(new), flushed_blocks=flushed)

    def _reject_all_locked(self, reason: str, what: str) -> int:
        """Fail every queued and active request with RejectedError(reason)
        ("<what> before prefill" / "<what> mid-decode"), free their rows
        and clear the tables. Returns how many; call under the lock."""
        n = 0
        for q in self._queues.values():
            while q:
                req = q.popleft()
                self._conclude(req, f"rejected:{reason}")
                if not req.handle.future.done():
                    req.handle.future.set_exception(RejectedError(
                        f"{what} before prefill", reason=reason))
                self.metrics.on_reject(reason)
                n += 1
        for slot, req in list(self._active.items()):
            self._conclude(req, f"rejected:{reason}")
            if not req.handle.future.done():
                req.handle.future.set_exception(RejectedError(
                    f"{what} mid-decode", reason=reason))
            self.metrics.on_reject(reason)
            self._free_slot_locked(slot, req)
            n += 1
        self._active.clear()
        if n:
            self.metrics.set_queue_depth(0)
            self.metrics.set_slots(self.pool.active_slots(),
                                   self.pool.num_slots)
        return n

    def _record_reject(self, reason: str, rid: Optional[str] = None,
                       tenant: Optional[str] = None):
        flight_recorder().record("reject", engine="llm", reason=reason,
                                 rid=rid, tenant=tenant)

    def _conclude(self, req: _GenRequest, outcome: str,
                  now: Optional[float] = None):
        """Finish a traced request's timeline on its terminal path
        (completed, expired, quarantined, failed, shed, rejected, handed
        off): close its phase spans, keep it in `timelines` and emit its
        spans onto the chrome trace. Once a request: a second terminal
        path leaves the first outcome. One predicate when untraced."""
        tr = req.trace
        if tr is None or tr.outcome is not None:
            return
        tr.finish(self.clock.now() if now is None else now, outcome)
        self.timelines.put(tr.rid, tr.to_dict())
        tr.emit_chrome()

    # ---- admission ----
    def _queue_len_locked(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _pop_next_locked(self) -> Optional[_GenRequest]:
        """Strict SLO-class priority, tenant-fair WITHIN a class: the
        oldest request of the tenant with the least active token usage
        (sum of cost over its slot-holding requests), so one tenant's
        burst cannot starve another at equal priority. With one tenant
        queued this is FIFO."""
        for cls in SLO_CLASSES:
            q = self._queues[cls]
            if not q:
                continue
            if len({r.tenant for r in q}) <= 1:
                return q.popleft()
            usage: Dict[str, int] = {}
            for r in self._active.values():
                usage[r.tenant] = usage.get(r.tenant, 0) + r.cost
            best_i = 0
            best_u = None
            for i, r in enumerate(q):           # FIFO tie-break
                u = usage.get(r.tenant, 0)
                if best_u is None or u < best_u:
                    best_i, best_u = i, u
            req = q[best_i]
            del q[best_i]
            return req
        return None

    def _tenant_inflight_locked(self, tenant: str) -> int:
        return (sum(r.cost for q in self._queues.values()
                    for r in q if r.tenant == tenant)
                + sum(r.cost for r in self._active.values()
                      if r.tenant == tenant))

    def _inflight_tokens_locked(self) -> int:
        """Estimated token cost of everything admitted: queued + active,
        recomputed from the tables, so no failure path can leak budget."""
        return (sum(r.cost for q in self._queues.values() for r in q)
                + sum(r.cost for r in self._active.values()))

    def _update_brownout_locked(self):
        if self.config.brownout_queue_depth is None:
            return
        depth = self._queue_len_locked()
        if not self._brownout and depth >= self.config.brownout_queue_depth:
            self._brownout = True
            self.metrics.set_brownout(True)
            _log.warning(
                "llm engine entering brownout at queue depth %d: capping "
                "admitted max_new_tokens to %d", depth,
                self.config.brownout_max_new_tokens)
        elif self._brownout and depth <= self.config.brownout_queue_depth // 2:
            self._brownout = False
            self.metrics.set_brownout(False)
            _log.info("llm engine exiting brownout at queue depth %d", depth)

    def _make_room_locked(self, slo: str, cost: int) -> Optional[str]:
        """Shed lowest first: while the queue or the token budget blocks
        this admission, fail the NEWEST queued request of the lowest class
        strictly below `slo` (reason "shed"). Returns None when the
        request can be admitted, else the reject reason."""
        pri = SLO_CLASSES.index(slo)
        while True:
            depth_full = (self._queue_len_locked()
                          >= self.config.max_queue_depth)
            budget = self.config.max_inflight_tokens
            over_budget = (budget is not None
                           and self._inflight_tokens_locked() + cost > budget)
            if not depth_full and not over_budget:
                return None
            victim = None
            for cls in reversed(SLO_CLASSES):   # lowest class first
                if SLO_CLASSES.index(cls) <= pri:
                    break
                if self._queues[cls]:
                    victim = self._queues[cls].pop()   # newest of its class
                    break
            if victim is None:
                return "queue_full" if depth_full else "token_budget"
            self._conclude(victim, "shed")
            victim.handle.future.set_exception(RejectedError(
                f"shed ({victim.slo}) to admit {slo} traffic under "
                "overload", reason="shed",
                retry_after_s=self.config.retry_after_s))
            self.metrics.on_reject("shed", tenant=victim.tenant)
            self.metrics.on_shed(victim.slo)
            if self.burn is not None:
                self.burn.observe(victim.slo, False, outcome="shed")
            self._record_reject("shed", rid=victim.rid,
                                tenant=victim.tenant)

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               slo: Optional[str] = None,
               logprobs: bool = False,
               sampling: Optional[SamplingParams] = None,
               sample_offset: int = 0,
               lane: Optional[dict] = None,
               tenant: Optional[str] = None,
               rid: Optional[str] = None,
               kv_row: Optional[dict] = None,
               trace: bool = False,
               adapter: Optional[str] = None) -> GenerationHandle:
        """Admit one prompt (1-D int token ids).

        `tenant` names the request's isolation domain
        (config.default_tenant when None): fair dequeue within a class,
        the optional in-flight token quota and a private prefix-cache
        namespace. `rid` is the request id (generated when None; it keys
        `export_stream`). `kv_row` (an `export_stream` payload's) carries
        the KV of the prompt's first `kv_row["length"]` tokens, which
        admission lands in the slot instead of prefilling them.
        `trace=True` keeps the request's timeline on the handle and, once
        it ends, in `timelines`. `adapter` names a loaded `AdapterBank`
        row: the stream then decodes under that adapter's LoRA delta in
        the same steps as its base and other-adapter batch-mates; None
        rides row 0, bit-equal to the unarmed engine. Naming one on an
        engine without a bank, or one not loaded, is a typed reject
        ("adapter_unavailable" / "unknown_adapter").

        `sampling` carries the request's sampling contract; None is
        greedy. `sample_offset` is the stream index of the first token
        this admission emits (the tokens already emitted elsewhere,
        re-prefilled as the prompt's tail), so draw i of the stream stays
        keyed by (seed, i) across a resubmission; a constrained request
        walks that tail through its grammar's DFA to resume the mask, or
        takes the DFA state from `lane` (an `export_sampling_lanes`
        entry) when its grammar and next index match.

        Raises RejectedError when the sequence can never fit a slot, the
        circuit breaker is open, the tenant's quota is spent, the queue is
        full or the token budget spent and nothing lower-priority can be
        shed, the grammar bank is full, or the engine is draining (an
        overload reject carries `retry_after_s`). While the engine is in
        brownout, `max_new_tokens` is capped at
        `config.brownout_max_new_tokens`. Raises ValueError on invalid
        sampling params, a resumed tail the grammar forbids or a kv_row
        that does not fit."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        sample_offset = int(sample_offset)
        if sample_offset < 0:
            raise ValueError(
                f"sample_offset must be >= 0, got {sample_offset}")
        mnt = (self.config.max_new_tokens if max_new_tokens is None
               else int(max_new_tokens))
        if mnt < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {mnt}")
        slo = self.config.default_slo if slo is None else slo
        if slo not in SLO_CLASSES:
            raise ValueError(
                f"slo must be one of {SLO_CLASSES}, got {slo!r}")
        tenant = self.config.default_tenant if tenant is None else tenant
        if not isinstance(tenant, str) or not tenant:
            raise ValueError("tenant must be a non-empty string")
        rid = rid or uuid.uuid4().hex
        if adapter is not None:
            if self.adapter_bank is None:
                self.metrics.on_reject("adapter_unavailable", tenant=tenant)
                self._record_reject("adapter_unavailable", rid=rid,
                                    tenant=tenant)
                raise RejectedError(
                    f"request names adapter {adapter!r} but the engine "
                    "was built without an adapter bank "
                    "(config.max_adapters=0)",
                    reason="adapter_unavailable")
            if self.adapter_bank.row_of(adapter) is None:
                self.metrics.on_reject("unknown_adapter", tenant=tenant)
                self._record_reject("unknown_adapter", rid=rid,
                                    tenant=tenant)
                raise RejectedError(
                    f"adapter {adapter!r} is not loaded "
                    f"(loaded: {self.adapter_bank.adapter_ids})",
                    reason="unknown_adapter")
        eos = (self.config.eos_token_id if eos_token_id is None
               else eos_token_id)
        gid, dstate0 = 0, 0
        if sampling is not None:
            sampling.validate()
            if sampling.grammar is not None:
                gid, dstate0 = self._grammar_row(sampling, eos, prompt,
                                                 sample_offset, lane,
                                                 rid=rid, tenant=tenant)
        if kv_row is not None:
            if int(kv_row.get("block_len", -1)) != self.pool.block_len:
                raise ValueError(
                    f"kv_row block_len {kv_row.get('block_len')!r} does "
                    f"not match the pool's ({self.pool.block_len}): KV "
                    "pages are not portable across block geometries")
            klen = int(kv_row["length"])
            if not 0 < klen <= prompt.size - 1:
                raise ValueError(
                    f"kv_row length {klen} must cover 1..{prompt.size - 1} "
                    "prompt tokens (at least one token always prefills — "
                    "that step emits the first token's logits)")
        if prompt.size + mnt > self.pool.capacity:
            self.metrics.on_reject("prompt_too_long")
            self._record_reject("prompt_too_long", rid=rid, tenant=tenant)
            raise RejectedError(
                f"prompt ({prompt.size}) + max_new_tokens ({mnt}) exceeds "
                f"slot capacity ({self.pool.capacity} tokens)",
                reason="prompt_too_long")
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        now = self.clock.now()
        deadline = None if deadline_ms is None else now + deadline_ms / 1e3
        with self._cond:
            if self.supervisor.open:
                self.metrics.on_reject("circuit_open")
                self._record_reject("circuit_open", rid=rid, tenant=tenant)
                raise RejectedError(
                    "engine circuit breaker open after repeated dispatch "
                    "failures; request rejected", reason="circuit_open")
            if self._draining or self._stopped:
                self.metrics.on_reject("draining")
                self._record_reject("draining", rid=rid, tenant=tenant)
                raise RejectedError("engine is draining; request rejected",
                                    reason="draining")
            self._update_brownout_locked()
            if self._brownout and mnt > self.config.brownout_max_new_tokens:
                mnt = self.config.brownout_max_new_tokens
            quota = self.config.tenant_max_inflight_tokens
            if quota is not None and (
                    self._tenant_inflight_locked(tenant)
                    + prompt.size + mnt > quota):
                # checked BEFORE shedding: shedding OTHER tenants'
                # requests cannot relieve this tenant's own quota
                self.metrics.on_reject("tenant_quota", tenant=tenant)
                self._record_reject("tenant_quota", rid=rid, tenant=tenant)
                raise RejectedError(
                    f"tenant {tenant!r} in-flight token quota exhausted "
                    f"({quota} tokens)", reason="tenant_quota",
                    retry_after_s=self.config.retry_after_s)
            reason = self._make_room_locked(slo, prompt.size + mnt)
            if reason is not None:
                self.metrics.on_reject(reason)
                self._record_reject(reason, rid=rid, tenant=tenant)
                detail = (f"queue at capacity ({self.config.max_queue_depth} "
                          "pending requests)" if reason == "queue_full" else
                          f"token budget exhausted "
                          f"({self.config.max_inflight_tokens} in-flight "
                          "tokens)")
                raise RejectedError(
                    f"{detail}; nothing below class {slo!r} to shed",
                    reason=reason,
                    retry_after_s=self.config.retry_after_s)
            req = _GenRequest(prompt, mnt, eos, now, deadline, slo,
                              self._submit_idx,
                              want_logprobs=bool(logprobs), tenant=tenant)
            req.rid = rid
            req.handle.rid = rid
            req.sampling = sampling
            req.sample_offset = sample_offset
            req.gid = gid
            req.dfa_state0 = dstate0
            req.kv_row = kv_row
            req.adapter = adapter
            if trace:
                req.trace = RequestTrace(rid, now, slo=slo, tenant=tenant)
                req.trace.event("submitted", now, prompt_len=int(prompt.size),
                                max_new_tokens=mnt,
                                submit_idx=self._submit_idx)
                req.handle.trace = req.trace
            self._submit_idx += 1
            self._queues[slo].append(req)
            self.metrics.on_submit(self._queue_len_locked(), slo=slo,
                                   tenant=tenant)
            self.metrics.set_inflight_tokens(self._inflight_tokens_locked())
            self._cond.notify_all()
        return req.handle

    def _grammar_row(self, sampling: SamplingParams, eos, prompt,
                     sample_offset: int, lane: Optional[dict],
                     rid: Optional[str] = None,
                     tenant: Optional[str] = None):
        """(bank row, starting DFA state) of a constrained request: its
        grammar compiled and interned on first use (a full bank is a
        typed reject, "grammar_capacity"), and the state after the tail
        it resumes from when sample_offset > 0."""
        tab = self.sampling_table
        gkey = sampling.grammar_key()
        gid = tab.lookup(gkey)
        if gid is None:
            tg0 = self.clock.now() if self.ledger is not None else None
            dfa = compile_grammar(sampling.grammar, tab.vocab_size, eos)
            try:
                gid = tab.intern(gkey, dfa)
            except ValueError as e:
                # bank capacity is an admission-control condition, not a
                # caller bug: typed reject, not ValueError
                self.metrics.on_reject("grammar_capacity")
                self._record_reject("grammar_capacity", rid=rid,
                                    tenant=tenant)
                raise RejectedError(str(e), reason="grammar_capacity")
            if tg0 is not None:
                self.ledger.book("sample_mask", self.clock.now() - tg0)
            self.metrics.set_grammars(tab.grammars_compiled)
        if not sample_offset:
            return gid, 0
        if lane is not None and lane.get("grammar_key") == gkey \
                and int(lane.get("next_index", -1)) == sample_offset:
            # the exported lane carries the DFA state at exactly this
            # admission's resume index: restore it directly, no re-walk
            return gid, int(lane["dfa_state"])
        # the prompt's tail is the constrained stream emitted so far:
        # walk it through the DFA so the mask resumes mid-grammar
        bank, q = tab.bank[gid], 0
        for t in prompt[-min(sample_offset, prompt.size):]:
            nq = int(bank[q, int(t)])
            if nq < 0:
                raise ValueError("resumed tail violates the request "
                                 f"grammar at token {int(t)}")
            q = nq
        return gid, q

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 timeout: Optional[float] = None,
                 slo: Optional[str] = None,
                 sampling: Optional[SamplingParams] = None,
                 tenant: Optional[str] = None) -> np.ndarray:
        """Synchronous convenience: submit + wait for the generated tokens."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           eos_token_id=eos_token_id,
                           deadline_ms=deadline_ms, slo=slo,
                           sampling=sampling, tenant=tenant).result(timeout)

    @staticmethod
    def _kv_ns(tenant: str, adapter: Optional[str] = None) -> str:
        """The prefix-cache and host-tier namespace of a stream: KV
        computed under an adapter's delta differs from base KV after the
        first adapted layer, so each (tenant, adapter) pair gets its own
        namespace (NUL cannot appear in a tenant id, so the composition
        is injective)."""
        return tenant if not adapter else f"{tenant}\x00adapter:{adapter}"

    def prefix_probe(self, prompt, tenant: Optional[str] = None,
                     adapter: Optional[str] = None) -> int:
        """Longest block-aligned cached prefix of `prompt`, in tokens, in
        either tier (device trie or host pool), in the namespace of
        (tenant, adapter); 0 with both off. Read-only: no refcounts,
        ticks or stats move."""
        tenant = self.config.default_tenant if tenant is None else tenant
        ns = self._kv_ns(tenant, adapter)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        host = (self.host_kv.probe(ns, prompt)
                if self.host_kv is not None else 0)
        if self.prefix_cache is None:
            return host
        return max(self.prefix_cache.probe(ns, prompt), host)

    @staticmethod
    def _lane(req: "_GenRequest", dfa_state: int) -> dict:
        """A request's sampling lane at its next stream index: what a
        resubmission needs to continue the stream elsewhere."""
        sp = req.sampling or GREEDY
        return {
            "seed": None if sp.seed is None else int(sp.seed),
            "next_index": req.sample_offset + len(req.emitted),
            "temperature": float(sp.temperature),
            "top_k": int(sp.top_k),
            "top_p": float(sp.top_p),
            "grammar_key": (sp.grammar_key() if sp.constrained else None),
            "dfa_state": int(dfa_state),
        }

    def export_sampling_lanes(self, slots) -> dict:
        """The sampling-lane state of active `slots`: per slot, the
        request's seed, the next stream index, the sampling params and,
        for a constrained row, the grammar key and current DFA state. A
        resubmission that passes these back (seed -> SamplingParams,
        next_index -> sample_offset, the entry -> lane) continues the
        stream as the uninterrupted run would."""
        out: Dict[int, dict] = {}
        with self._cond:
            tab = self.sampling_table
            for slot in slots:
                slot = int(slot)
                req = self._active.get(slot)
                if req is None:
                    raise ValueError(f"slot {slot} has no active request")
                out[slot] = self._lane(req, tab.dfa_state[slot])
        return out

    def export_stream(self, rid: str) -> dict:
        """Export ONE decoding stream for a handoff and free its row, under
        one lock acquisition, so no step advances the stream between the
        snapshot and the release.

        The stream must have emitted a token: its row's KV then covers
        ``len(prompt) + len(emitted) - 1`` tokens (the last token's KV is
        written by the step that consumes it), so a peer that resubmits
        ``prompt + emitted`` with this payload's `kv_row` and `lane`
        (sample_offset = len(emitted)) prefills one token and continues
        the stream as the uninterrupted run would. The payload's KV is
        CPU tensors in the slab dtype. This engine's handle is left
        unresolved: the receiving engine's handle carries the stream on.
        Raises ValueError when the rid is not active or still
        mid-prefill."""
        with self._cond:
            found = next(((slot, req) for slot, req in self._active.items()
                          if req.rid == rid), None)
            if found is None:
                raise ValueError(f"no active stream with rid {rid!r}")
            slot, req = found
            if req.chunk_off < len(req.prompt) or not req.emitted:
                raise ValueError(
                    f"stream {rid!r} has not completed prefill: a handoff "
                    "exports post-prefill KV only")
            row = self.pool.export_rows([slot])["rows"][slot]
            payload = {
                "rid": rid,
                "tenant": req.tenant,
                "prompt": np.asarray(req.prompt, np.int32).copy(),
                "emitted": list(req.emitted),
                "logprobs": (req.handle.logprobs_so_far()
                             if req.want_logprobs else None),
                "kv_row": {
                    "block_len": self.pool.block_len,
                    "length": int(row["length"]),
                    "layers": row["layers"],
                },
                "lane": self._lane(req, self.sampling_table.dfa_state[slot]),
                "weight_version": self.weight_version,
                "adapter": req.adapter,
            }
            self._conclude(req, "handoff")
            self._free_slot_locked(slot, req)
            del self._active[slot]
            self.metrics.set_slots(self.pool.active_slots(),
                                   self.pool.num_slots)
            self._cond.notify_all()
        flight_recorder().record(
            "kv_export", engine="llm", rid=rid,
            tokens=int(payload["kv_row"]["length"]),
            emitted=len(payload["emitted"]))
        return payload

    # ---- multi-LoRA adapter lifecycle ----
    def _flush_adapter_kv(self, adapter_id: str):
        """Drop ONE adapter's (tenant, adapter) KV namespaces from both
        cache tiers: its cached KV was computed under the delta being
        replaced. Base and other-adapter namespaces stay warm."""
        suffix = f"\x00adapter:{adapter_id}"
        with self._cond:
            if self.prefix_cache is not None:
                # clears the matching host-tier namespaces too
                self.prefix_cache.clear(only=lambda ns: ns.endswith(suffix))
            elif self.host_kv is not None:
                self.host_kv.clear(only=lambda ns: ns.endswith(suffix))

    def _require_bank(self) -> AdapterBank:
        if self.adapter_bank is None:
            raise AdapterError(
                "engine built without an adapter bank "
                "(config.max_adapters=0)", reason="adapter_unavailable")
        return self.adapter_bank

    def register_adapter(self, adapter_id: str, tree,
                         alpha: Optional[float] = None):
        """Load, or hot-swap when the id is resident, one adapter into a
        bank row, with no drain: the row is written copy-on-write (the
        module docstring says why), so a step already running keeps the
        old rows and the next one reads the new. The tree is validated
        against the base-model signature first (typed AdapterError on a
        rank, target or shape mismatch). A swap flushes the adapter's KV
        namespaces. Returns the PRIOR row snapshot (None for a fresh
        load): the rollback token `rollback_adapter` restores."""
        bank = self._require_bank()
        prior = bank.snapshot_row(adapter_id)
        row = bank.load(adapter_id, tree, alpha=alpha)
        if prior is not None:
            self._flush_adapter_kv(adapter_id)
        flight_recorder().record(
            "adapter_swap", engine="llm", adapter=str(adapter_id),
            row=row, update=prior is not None,
            bank_version=bank.version)
        self.metrics.on_adapter_swap()
        return prior

    def rollback_adapter(self, adapter_id: str, snapshot):
        """Restore a bank row to a `register_adapter` rollback token
        (None = the adapter was fresh: unload it). In-flight streams on
        the row continue on the restored values: no drop, no drain."""
        bank = self._require_bank()
        bank.restore(adapter_id, snapshot)
        self._flush_adapter_kv(adapter_id)
        flight_recorder().record(
            "adapter_rollback", engine="llm", adapter=str(adapter_id),
            restored=snapshot is not None, bank_version=bank.version)
        self.metrics.on_adapter_rollback()

    def unregister_adapter(self, adapter_id: str):
        """Unload an adapter and zero its row. Typed refusal
        ("adapter_in_use") while any queued or active stream still
        decodes under it: unloading would flip those streams to a zero
        delta mid-sequence."""
        bank = self._require_bank()
        with self._cond:
            users = [r.rid for r in self._active.values()
                     if r.adapter == adapter_id]
            users += [r.rid for q in self._queues.values()
                      for r in q if r.adapter == adapter_id]
            if users:
                raise AdapterError(
                    f"adapter {adapter_id!r} still has {len(users)} "
                    f"in-flight stream(s) ({users[:4]}...): drain or "
                    "finish them first", reason="adapter_in_use")
            bank.unload(adapter_id)
        flight_recorder().record(
            "adapter_unload", engine="llm", adapter=str(adapter_id),
            bank_version=bank.version)

    @torch.no_grad()
    def canary_probe(self, prompt, max_new_tokens: int = 4,
                     adapter: Optional[str] = None):
        """Golden-prompt canary: greedy-decode `max_new_tokens` tokens
        straight through the model on the contiguous cache (a cache of its
        own, outside the scheduler and the pool), checking that every
        logit is finite. `adapter` probes through that bank row's LoRA
        delta, the gate a hot swap must clear (typed AdapterError when it
        is not loaded or there is no bank). Returns (tokens np.int32
        [max_new_tokens], logits_finite bool)."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("canary prompt must be non-empty")
        adapters = None
        if adapter is not None:
            bank = self._require_bank()
            row = bank.row_of(adapter)
            if row is None:
                raise AdapterError(f"unknown adapter {adapter!r}",
                                   reason="unknown_adapter")
            adapters = bank.args_for_rows([row])
        dev = self.pool.device
        caches = self.model.init_cache(1, int(prompt.size)
                                       + int(max_new_tokens))
        logits, caches = self.model.forward_with_cache(
            torch.from_numpy(prompt[None, :]).to(dev), caches, 0,
            adapters=adapters)
        finite = bool(torch.isfinite(logits).all())
        last = int(torch.argmax(logits[0, -1].float()))
        toks = [last]
        pos = int(prompt.size)
        for _ in range(int(max_new_tokens) - 1):
            logits, caches = self.model.forward_with_cache(
                torch.tensor([[last]], dtype=torch.int32, device=dev),
                caches, pos, adapters=adapters)
            finite = finite and bool(torch.isfinite(logits).all())
            last = int(torch.argmax(logits[0, -1].float()))
            toks.append(last)
            pos += 1
        return np.asarray(toks, dtype=np.int32), finite

    def inflight_tokens(self) -> int:
        """Admitted token cost (queued + active): the router's load
        tie-breaker."""
        with self._cond:
            return self._inflight_tokens_locked()

    # ---- scheduling ----
    def has_work(self) -> bool:
        with self._cond:
            return bool(self._queue_len_locked() or self._active)

    def pump(self) -> int:
        """One scheduler pass: drop expired queued requests, admit queued
        requests into free slots (bookkeeping only), run ONE unified step
        and retire finished or expired rows. Returns 1 when the step
        carried a decode row, else 0. With economics armed the pass runs
        inside the ledger's ``measure("host")`` frame, out of which
        `_step_once` books the successful step's span."""
        led = self.ledger
        if led is None:
            return self._pump_inner()
        with led.measure("host"):
            return self._pump_inner()

    def _pump_inner(self) -> int:
        now = self.clock.now()
        # time-weighted slot occupancy: the level held since the last pass
        self.metrics.observe_occupancy(now)
        self._drop_expired_queued(now)
        self._admit()
        n = self._step_once()
        with self._cond:
            self.metrics.set_inflight_tokens(self._inflight_tokens_locked())
            per_tenant: Dict[str, int] = {}
            for r in [r for q in self._queues.values() for r in q] \
                    + list(self._active.values()):
                per_tenant[r.tenant] = per_tenant.get(r.tenant, 0) + r.cost
            self.metrics.set_tenant_inflight(per_tenant)
        if self.prefix_cache is not None:
            self.metrics.set_prefix_cache(
                self.prefix_cache.stats["cached_blocks"],
                self.prefix_cache.stats["evictions"],
                {t: s["cached_blocks"]
                 for t, s in self.prefix_cache.tenant_stats.items()})
        if self.host_kv is not None:
            self.metrics.set_host_kv(self.host_kv.snapshot())
            if self.ledger is not None and self.prefix_cache is not None:
                # spills happen inside pool.allocate's pressure hook
                # (mid-_admit); the cache sums their time and the pump
                # books the new part as kv_spill
                spill = self.prefix_cache.spill_seconds
                if spill > self._spill_booked:
                    self.ledger.book("kv_spill", spill - self._spill_booked)
                    self._spill_booked = spill
        self.metrics.set_fragmentation(self.pool.fragmentation_ratio())
        return n

    def _drop_expired_queued(self, now: float):
        with self._cond:
            expired = 0
            for cls, q in self._queues.items():
                if not q:
                    continue
                alive = deque()
                for r in q:
                    if r.deadline is not None and now >= r.deadline:
                        self._conclude(r, "expired:queued", now)
                        r.handle.future.set_exception(DeadlineExceededError(
                            f"deadline expired after "
                            f"{(now - r.arrival) * 1e3:.1f}ms in queue "
                            "(dropped before prefill)"))
                        if self.burn is not None:
                            self.burn.observe(r.slo, False,
                                              outcome="expired_queued")
                        expired += 1
                    else:
                        alive.append(r)
                if len(alive) != len(q):
                    self._queues[cls] = alive
            if expired:
                self.metrics.on_expire(expired)
                self.metrics.set_queue_depth(self._queue_len_locked())

    def _admit(self):
        """Move queued requests into free slots, highest SLO class first.
        A request's covered prefix is settled here, on the slot's own
        device: a handed-off `kv_row` is imported, else the prefix cache's
        full blocks are attached and its partial block copied-on-write,
        then the host tier's spilled blocks are onboarded past a block
        boundary. Its remaining prompt chunks ride the next unified
        steps."""
        with self._cond:
            while True:
                self._update_brownout_locked()
                if self.supervisor.open or self.pool.free_slots() == 0:
                    return
                req = self._pop_next_locked()
                if req is None:
                    return
                self.metrics.set_queue_depth(self._queue_len_locked())
                try:
                    slot = self.pool.allocate(req.cost)
                except SlotsExhaustedError:
                    # every free row is pinned by cached pages with live
                    # readers; retry once readers drain
                    self._queues[req.slo].appendleft(req)
                    self.metrics.set_queue_depth(self._queue_len_locked())
                    return
                req.slot = slot
                req.chunk_off = 0
                req.attached_pages = []
                if req.trace is not None:
                    t_adm = self.clock.now()
                    req.trace.mark("admitted", t_adm)
                    req.trace.event(
                        "admitted", t_adm, slot=slot,
                        queue_wait_ms=(t_adm - req.arrival) * 1e3)
                ns = self._kv_ns(req.tenant, req.adapter)
                bl = self.pool.block_len
                if req.kv_row is not None:
                    # land the exported row in the slot's own pages; the
                    # next chunk's set_length claims them as a cold
                    # prefill would
                    t0 = self.clock.now() if self.ledger is not None \
                        else None
                    klen = int(req.kv_row["length"])
                    layers = req.kv_row["layers"]
                    for j in range(0, klen, bl):
                        w = min(bl, klen - j)
                        self.pool.import_page(
                            slot, j // bl, [(k[:, j:j + w], v[:, j:j + w])
                                            for k, v in layers])
                    req.chunk_off = klen
                    self.kv_import_tokens += klen
                    if t0 is not None:
                        self.ledger.book("kv_onboard", self.clock.now() - t0)
                    flight_recorder().record(
                        "kv_import", engine="llm", rid=req.rid,
                        tokens=klen)
                    if req.trace is not None:
                        req.trace.event("kv_import", self.clock.now(),
                                        tokens=klen)
                elif self.prefix_cache is not None:
                    # cap at plen-1: one prompt token always prefills
                    plan = self.prefix_cache.acquire(
                        ns, req.prompt, max_tokens=len(req.prompt) - 1)
                    if plan.pages:
                        self.pool.attach_blocks(slot, plan.pages)
                        req.attached_pages = list(plan.pages)
                    if plan.tail_page is not None:
                        self.pool.cow_copy(plan.tail_page, slot)
                    req.chunk_off = plan.attach_len
                    # the slot holds its own refs and tail copy now
                    self.prefix_cache.release(plan)
                    self.metrics.on_prefix_lookup(
                        req.tenant, plan.attach_len, len(req.prompt))
                    if req.trace is not None:
                        req.trace.event(
                            "prefix_lookup", self.clock.now(),
                            attach_len=plan.attach_len,
                            prompt_len=len(req.prompt))
                # host-tier onboard: from a block-aligned coverage end,
                # walk the spilled blocks into the slot's own pages (a COW
                # tail ends the walk); the completed prefill re-indexes
                # them in the device trie
                if (self.host_kv is not None and req.kv_row is None
                        and req.chunk_off % bl == 0):
                    t0 = self.clock.now() if self.ledger is not None \
                        else None
                    j = req.chunk_off // bl
                    onboarded = 0
                    while (j + 1) * bl <= len(req.prompt) - 1:
                        layers = self.host_kv.get(ns,
                                                  req.prompt[:(j + 1) * bl])
                        if layers is None:
                            break
                        self.pool.import_page(slot, j, layers)
                        j += 1
                        onboarded += 1
                    if onboarded:
                        req.chunk_off = j * bl
                        self.host_onboard_tokens += onboarded * bl
                        if t0 is not None:
                            self.ledger.book("kv_onboard",
                                             self.clock.now() - t0)
                        flight_recorder().record(
                            "kv_onboard", engine="llm", rid=req.rid,
                            blocks=onboarded, tokens=onboarded * bl)
                        if req.trace is not None:
                            req.trace.event(
                                "kv_onboard", self.clock.now(),
                                blocks=onboarded, tokens=onboarded * bl)
                self.sampling_table.bind(slot, req.sampling or GREEDY,
                                         gid=req.gid,
                                         dfa_state=req.dfa_state0)
                # the slot's adapter_idx points at the request's bank row;
                # an adapter unloaded since submit is a typed reject here,
                # never a wrong-delta decode
                if self.adapter_bank is not None:
                    try:
                        self.adapter_bank.bind_slot(slot, req.adapter)
                    except AdapterError as e:
                        self._conclude(req, "rejected:unknown_adapter")
                        req.handle.future.set_exception(RejectedError(
                            f"adapter {req.adapter!r} was unloaded before "
                            f"admission ({e})", reason="unknown_adapter"))
                        self.metrics.on_reject("unknown_adapter",
                                               tenant=req.tenant)
                        self._record_reject("unknown_adapter", rid=req.rid,
                                            tenant=req.tenant)
                        self._free_slot_locked(slot, req)
                        continue
                if (self.draft_pool is not None and not self._spec_disabled
                        and req.gid == 0):
                    self._admit_draft_locked(req)
                self._active[slot] = req
                self.metrics.set_slots(self.pool.active_slots(),
                                       self.pool.num_slots)
                self.metrics.set_sample_slots(
                    self.sampling_table.mode_counts(self._active))

    def _admit_draft_locked(self, req: _GenRequest):
        """Give an unconstrained request a draft row (a constrained one's
        mask depends on a DFA state the draft cannot see ahead of, so it
        never speculates). An exhausted draft pool is not an error: the
        request runs without speculation. With the prefix cache on, the
        draft cache attaches the prompt's cached prefix under the same cap
        as the target's (both pools share block_len, so both sides skip
        the same span) and the draft's catch-up starts past it."""
        dpool = self.draft_pool
        try:
            ds = dpool.allocate(req.cost)
        except SlotsExhaustedError:
            return
        req.draft_slot = ds
        if self.draft_prefix_cache is None:
            return
        plan = self.draft_prefix_cache.acquire(
            req.tenant, req.prompt, max_tokens=len(req.prompt) - 1)
        if plan.pages:
            dpool.attach_blocks(ds, plan.pages)
            req.draft_attached = list(plan.pages)
        if plan.tail_page is not None:
            dpool.cow_copy(plan.tail_page, ds)
        if plan.attach_len:
            dpool.set_length(ds, plan.attach_len)
        self.draft_prefix_cache.release(plan)

    # ---- speculative decoding ----
    def _stream_token(self, req: _GenRequest, i: int) -> int:
        """Token i of the request's committed stream (prompt + emitted):
        what the draft's catch-up replays."""
        plen = len(req.prompt)
        return int(req.prompt[i]) if i < plen else int(req.emitted[i - plen])

    def _catchup_args(self, toks: np.ndarray, pos: np.ndarray,
                      adv: np.ndarray) -> _DraftArgs:
        """A catch-up's operands on the draft pool's device: each draft
        row's chunk `toks [N, C]` written at `pos [N]`, `adv [N]` of its
        columns real (0: the row parks at the pad, pos = capacity)."""
        dpool = self.draft_pool
        dev = dpool.device
        d = _DraftArgs()
        d.toks_d = torch.from_numpy(toks).to(dev)
        d.pos_d = torch.from_numpy(pos).to(dev)
        d.seq_lens = d.pos_d + torch.from_numpy(adv).to(dev)
        d.table = dpool.device_block_table()
        d.slabs = dpool.slabs
        d.stream = _current_stream(dev)
        d.params = d.keys = None
        return d

    def _propose_args(self, tok0: np.ndarray, pos: np.ndarray,
                      act: np.ndarray, lanes=None) -> _DraftArgs:
        """A propose's operands: `tok0 [N]` each draft row's last
        committed token, which step 0 writes at `pos [N]`; `act [N]` is 1
        for a proposing row, 0 for a row parked at the pad (pos =
        capacity), which advances nothing. `lanes`, when a proposing row
        samples, is (temperature, top_k, top_p, do_sample, target slot,
        stream index) by draft row: step j draws on lane index + j of the
        target slot's seed. Every step's positions and lengths go up in
        one copy, every step's lane keys in another."""
        K = self.config.spec_k
        dpool = self.draft_pool
        dev = dpool.device
        N = dpool.num_slots
        at = pos[None, :] + np.arange(K + 2, dtype=np.int32)[:, None] * act
        d = _DraftArgs()
        d.toks_d = torch.from_numpy(tok0).to(dev)
        both = torch.from_numpy(np.stack([at[:K + 1], at[1:]])).to(dev)
        d.pos_d, d.seq_lens = both[0], both[1]
        d.table = dpool.device_block_table()
        d.slabs = dpool.slabs
        d.stream = _current_stream(dev)
        d.params = d.keys = None
        if lanes is not None:
            temp, topk, topp, samp, tslot, ctr = lanes
            d.params = tuple(torch.from_numpy(x).to(dev)
                             for x in (temp, topk, topp, samp))
            idx = (ctr[None, :] + np.arange(K, dtype=np.int32)[:, None])
            d.keys = self.sampling_table.lane_keys(
                idx.reshape(-1), rows=np.tile(tslot, K)).reshape(K, N, 2)
        return d

    def _probe_draft_args(self, tok: int, ds: int, at: int) -> _DraftArgs:
        """A greedy propose of draft row `ds` alone, its first token `tok`
        written at `at`, every other row parked at the pad."""
        dpool = self.draft_pool
        N = dpool.num_slots
        tok0 = np.zeros((N,), np.int32)
        pos = np.full((N,), dpool.capacity, np.int32)
        act = np.zeros((N,), np.int32)
        tok0[ds], pos[ds], act[ds] = tok, at, 1
        return self._propose_args(tok0, pos, act)

    def _catchup_attempt(self, d: _DraftArgs):
        """The callable of one catch-up attempt: a chunk-wide draft
        forward under the attempt's write token, its logits discarded
        (only the KV stripes matter). With the ledger armed it waits for
        the device, so the booked span is the catch-up's."""
        dpool = self.draft_pool

        def run(fence: _WriteFence):
            stream = (torch.cuda.stream(d.stream) if d.stream is not None
                      else contextlib.nullcontext())
            with torch.no_grad(), stream, kv_write_guard(fence):
                paged = (d.table, d.seq_lens, dpool.block_len,
                         dpool.n_blocks)
                self.draft_model.forward_with_cache(d.toks_d, d.slabs,
                                                    d.pos_d, paged=paged)
                if d.stream is not None and self.ledger is not None:
                    d.stream.synchronize()
        return run

    def _propose_attempt(self, d: _DraftArgs):
        """The callable of one propose attempt: spec_k + 1 width-1 draft
        forwards under the attempt's write token. Step j feeds step j-1's
        selection (tok0 at step 0), which stays on the device, and the
        drafts d1..dK come back in one copy, [N, K] numpy; step K feeds dK
        for its KV write alone, so after an all-accept window the draft
        needs no catch-up. A greedy propose takes the argmax (what
        `select_next` gives a greedy row); a sampled one `select_next` on
        step j's lane keys."""
        K = self.config.spec_k
        dpool = self.draft_pool
        model = self.draft_model

        def run(fence: _WriteFence):
            stream = (torch.cuda.stream(d.stream) if d.stream is not None
                      else contextlib.nullcontext())
            with torch.no_grad(), stream, kv_write_guard(fence):
                tok = d.toks_d
                drafts = []
                for j in range(K + 1):
                    paged = (d.table, d.seq_lens[j], dpool.block_len,
                             dpool.n_blocks)
                    lg, _ = model.forward_with_cache(
                        tok[:, None], d.slabs, d.pos_d[j], paged=paged)
                    if j == K:
                        break
                    if d.keys is None:
                        tok = torch.argmax(lg[:, 0].float(),
                                           dim=-1).to(torch.int32)
                    else:
                        temp, topk, topp, samp = d.params
                        tok = select_next(lg[:, 0], temp, topk, topp, samp,
                                          None, None, keys=d.keys[j])
                    drafts.append(tok)
                return torch.stack(drafts, dim=1).cpu().numpy()
        return run

    def _draft_phase(self) -> Dict[int, List[int]]:
        """The pump's draft work, before the target's step: one chunk-wide
        catch-up over the rows whose draft KV trails the target's
        committed stream (prompt chunks, a window's corrective token),
        then one propose (`_draft_propose`). Returns {target slot: [d1..
        dK]}, the windows `_build_rows_locked` puts into the step. Both
        attempts announce kind "draft" and are breaker-exempt: a failure
        costs this pump its speculation (and a blamed request its draft),
        never a stream."""
        if self.draft_pool is None or self._spec_disabled:
            return {}
        C = self.config.prefill_chunk
        dpool = self.draft_pool
        N = dpool.num_slots
        with self._cond:
            toks = np.zeros((N, C), np.int32)
            pos = np.full((N,), dpool.capacity, np.int32)
            adv = np.zeros((N,), np.int32)
            catchup: List[Tuple[int, _GenRequest, int, int, int]] = []
            for slot, req in self._active.items():
                ds = req.draft_slot
                if ds is None or req.spec_off:
                    continue
                tlen = int(self.pool.lengths[slot])
                dlen = int(dpool.lengths[ds])
                if dlen >= tlen:
                    continue
                n = min(C, tlen - dlen)
                toks[ds, :n] = [self._stream_token(req, dlen + j)
                                for j in range(n)]
                pos[ds] = dlen
                adv[ds] = n
                catchup.append((slot, req, ds, dlen, n))
            d = self._catchup_args(toks, pos, adv) if catchup else None
        if catchup:
            rids = tuple(sorted(r.submit_idx for _, r, *_ in catchup))
            t0 = self.clock.now() if self.ledger is not None else None
            try:
                self._run_dispatch((("draft", rids),),
                                   self._catchup_attempt(d), exempt=True)
            except DispatchFailedError as e:
                self._draft_failure([(s, r) for s, r, *_ in catchup], e,
                                    "catchup")
                return {}
            if t0 is not None:
                self.ledger.book_dispatch(
                    self.clock.now() - t0, prefill_positions=0,
                    decode_positions=0, total_positions=0,
                    owners=[(r.tenant, r.slo, n)
                            for _, r, _, _, n in catchup],
                    draft_positions=int(sum(n for *_, n in catchup)))
            with self._cond:
                for slot, req, ds, dlen, n in catchup:
                    if self._active.get(slot) is not req \
                            or req.draft_slot != ds:
                        continue
                    dpool.set_length(ds, dlen + n)
                    if (self.draft_prefix_cache is not None
                            and dlen < len(req.prompt) <= dlen + n):
                        # the draft's prompt KV just completed: index it,
                        # so siblings attach on the draft side too
                        self.draft_prefix_cache.insert(
                            req.tenant, req.prompt, ds, req.draft_attached)
            self._draft_failstreak = 0
        return self._draft_propose()

    def _draft_propose(self) -> Dict[int, List[int]]:
        """One propose over every row that can take a window: past
        prefill, its draft caught up to the target's committed length L,
        at least 2 tokens left, and L + K + 1 within the slot. Sampling
        operands are gathered by draft row; each row's step j draws on
        its lane `sample_offset + emitted + j`, the lane the verify draws
        column j on. The draft rows then hold K+1 stripes past L
        (set_length L+K+1), which the commit rewinds to what the verify
        accepts."""
        K = self.config.spec_k
        dpool = self.draft_pool
        N = dpool.num_slots
        with self._cond:
            tok0 = np.zeros((N,), np.int32)
            ppos = np.full((N,), dpool.capacity, np.int32)
            act = np.zeros((N,), np.int32)
            temp = np.ones((N,), np.float32)
            topk = np.zeros((N,), np.int32)
            topp = np.ones((N,), np.float32)
            samp = np.zeros((N,), bool)
            tslot = np.zeros((N,), np.int64)
            dctr = np.zeros((N,), np.int32)
            tab = self.sampling_table
            eligible: List[Tuple[int, _GenRequest, int, int]] = []
            for slot, req in self._active.items():
                ds = req.draft_slot
                if ds is None or req.spec_off or req.gid > 0:
                    continue
                if req.chunk_off < len(req.prompt):
                    continue            # still in chunked prefill
                L = int(self.pool.lengths[slot])
                if int(dpool.lengths[ds]) != L:
                    continue            # draft KV still catching up
                if req.max_new_tokens - len(req.emitted) < 2:
                    continue            # a window cannot beat one step
                if L + K + 1 > self.pool.capacity:
                    continue            # the window would overrun the slot
                tok0[ds], ppos[ds], act[ds] = req.last_tok, L, 1
                temp[ds] = tab.temperature[slot]
                topk[ds] = tab.top_k[slot]
                topp[ds] = tab.top_p[slot]
                samp[ds] = tab.do_sample[slot]
                tslot[ds] = slot
                dctr[ds] = req.sample_offset + len(req.emitted)
                eligible.append((slot, req, ds, L))
            if not eligible:
                return {}
            d = self._propose_args(
                tok0, ppos, act,
                (temp, topk, topp, samp, tslot, dctr) if samp.any()
                else None)
        rids = tuple(sorted(r.submit_idx for _, r, _, _ in eligible))
        t0 = self.clock.now() if self.ledger is not None else None
        try:
            drafts = self._run_dispatch((("draft", rids),),
                                        self._propose_attempt(d),
                                        exempt=True)
        except DispatchFailedError as e:
            self._draft_failure([(s, r) for s, r, _, _ in eligible], e,
                                "propose")
            return {}
        if t0 is not None:
            self.ledger.book_dispatch(
                self.clock.now() - t0, prefill_positions=0,
                decode_positions=0, total_positions=0,
                owners=[(r.tenant, r.slo, K + 1) for _, r, _, _ in eligible],
                draft_positions=(K + 1) * len(eligible))
        spec: Dict[int, List[int]] = {}
        with self._cond:
            for slot, req, ds, L in eligible:
                if self._active.get(slot) is not req or req.draft_slot != ds:
                    continue
                dpool.set_length(ds, L + K + 1)
                spec[slot] = [int(t) for t in drafts[ds]]
        self._draft_failstreak = 0
        return spec

    def _draft_failure(self, rows, err, stage: str):
        """A draft attempt failed (no retry: a failure only costs this
        pump its speculation). Each riding request is probed alone by a
        greedy propose of its own draft row at its committed draft length:
        where a real propose writes, past the committed draft KV, which
        the probe leaves intact (JAX probes at position 0, which here
        would overwrite it); a row without room for a window there is not
        probed. A blamed request loses its draft (spec_off, draft row
        freed) and its stream continues as plain decode. A failure no
        request explains (every probe of several failed, or none did)
        counts a streak that disables speculation engine-wide at
        breaker_threshold. The target breaker is never charged."""
        dpool = self.draft_pool
        K = self.config.spec_k
        blamed = []
        for slot, req in rows:
            with self._cond:
                ds = req.draft_slot
                if ds is None:
                    continue
                dlen = int(dpool.lengths[ds])
                if dlen + K + 1 > dpool.capacity:
                    continue
                d = self._probe_draft_args(req.last_tok, ds, dlen)
            try:
                self._run_dispatch((("draft", (req.submit_idx,)),),
                                   self._propose_attempt(d), exempt=True)
            except DispatchFailedError as probe_err:
                blamed.append((slot, req, probe_err))
                flight_recorder().record(
                    "solo_probe", engine="llm", rid=req.rid,
                    submit_idx=req.submit_idx, stage="draft",
                    outcome="failed")
            else:
                flight_recorder().record(
                    "solo_probe", engine="llm", rid=req.rid,
                    submit_idx=req.submit_idx, stage="draft", outcome="ok")
        if blamed and (len(blamed) < len(rows) or len(rows) == 1):
            with self._cond:
                for slot, req, probe_err in blamed:
                    if self._active.get(slot) is not req:
                        continue
                    req.spec_off = True
                    ds = req.draft_slot
                    if ds is not None and dpool.active[ds]:
                        dpool.free(ds)
                    req.draft_slot = None
                    self.metrics.on_draft_quarantine()
                    flight_recorder().record(
                        "draft_quarantine", engine="llm", rid=req.rid,
                        submit_idx=req.submit_idx, stage=stage,
                        reason="poisoned_draft", error=str(probe_err))
            _log.warning(
                "quarantined the draft of %d request(s) after a failed "
                "%s attempt; their streams continue as plain decode",
                len(blamed), stage)
            return
        self._draft_failstreak += 1
        flight_recorder().record(
            "draft_failure", engine="llm", stage=stage,
            failstreak=self._draft_failstreak, error=str(err))
        if self._draft_failstreak >= self.config.breaker_threshold:
            self._spec_disabled = True
            flight_recorder().record(
                "draft_disabled", engine="llm",
                failstreak=self._draft_failstreak)
            _log.error(
                "disabling speculative decoding after %d consecutive draft "
                "failures no request explains; the engine continues on "
                "plain decode", self._draft_failstreak)

    def _acceptance_locked(self, decode_slots, spec_drafts,
                           nxt) -> Dict[int, Tuple[List[int], int, int]]:
        """Verification over the step's per-position selections: for each
        decode row, the longest prefix of its window's drafts that equals
        the target's own selection at each position, then the target's
        one corrective token, cut at the request's EOS or max tokens where
        sequential decode would stop. Returns {slot: (tokens to emit,
        accepted drafts, drafted)}; a plain decode row gives ([next
        token], 0, 0), the plain commit."""
        accept: Dict[int, Tuple[List[int], int, int]] = {}
        for slot in decode_slots:
            req = self._active.get(slot)
            if req is None:
                continue
            drafts = spec_drafts.get(slot, ())
            row = nxt[slot]
            k = len(drafts)
            a = 0
            while a < k and int(row[a]) == int(drafts[a]):
                a += 1
            emit: List[int] = []
            for j in range(a + 1):
                tok = int(row[j])
                emit.append(tok)
                if len(req.emitted) + len(emit) >= req.max_new_tokens:
                    break
                if req.eos_token_id is not None and tok == req.eos_token_id:
                    break
            accept[slot] = (emit, min(len(emit), a), k)
        return accept

    def _build_rows_locked(self, spec_drafts=None):
        """(toks [N, C], pos [N], adv [N], ctr [N], prefill_slots,
        decode_slots). Free slots stay all-zero with adv=0 and write their
        discarded C-wide stripe into the slab's pad region (pos =
        capacity), which no block table addresses. A decode row with a
        window in `spec_drafts` carries [last_tok, d1..dk] at adv = 1+k.
        `ctr` is each row's stream index at its emission column adv-1
        (column 0 of a window), sample_offset + emitted for prefill and
        decode rows alike (the JAX engine backs column 0 of a prefill row
        off by adv-1 to land there)."""
        N = self.pool.num_slots
        C = self.config.prefill_chunk
        toks = np.zeros((N, C), np.int32)
        pos = np.full((N,), self.pool.capacity, np.int32)
        adv = np.zeros((N,), np.int32)
        ctr = np.zeros((N,), np.int32)
        prefill_slots: List[int] = []
        decode_slots: List[int] = []
        for slot, req in self._active.items():
            plen = len(req.prompt)
            ctr[slot] = req.sample_offset + len(req.emitted)
            if req.chunk_off < plen:
                off = req.chunk_off
                n = min(C, plen - off)
                toks[slot, :n] = req.prompt[off:off + n]
                pos[slot] = off
                adv[slot] = n
                prefill_slots.append(slot)
            else:
                drafts = spec_drafts.get(slot, ()) if spec_drafts else ()
                toks[slot, 0] = req.last_tok
                toks[slot, 1:1 + len(drafts)] = drafts
                pos[slot] = self.pool.lengths[slot]
                adv[slot] = 1 + len(drafts)
                decode_slots.append(slot)
        return toks, pos, adv, ctr, prefill_slots, decode_slots

    def _step_once(self) -> int:
        """Run ONE unified step over every slot, supervised, and commit
        its results. Returns 1 when the committed step carried at least
        one decode row, else 0. With a draft model the draft phase runs
        first and decode rows carry its windows. A failed attempt is
        retried whole `dispatch_retries` times; then `_blame_and_quarantine`
        probes each row alone, and the survivors of a quarantine retry on
        a rebuilt row set with the same windows (a failed step commits
        nothing); a failure no row explains fails every active row and
        charges the circuit breaker. A step in which no active request
        samples or is constrained runs the greedy selection alone."""
        spec_drafts = self._draft_phase()
        while True:
            with self._cond:
                if not self._active:
                    return 0
                toks, pos, adv, ctr, prefill_slots, decode_slots = \
                    self._build_rows_locked(spec_drafts)
                verify = None
                if spec_drafts:
                    verify = np.zeros(adv.shape, bool)
                    verify[[s for s in decode_slots
                            if spec_drafts.get(s)]] = True
                kinds = self._kinds_of(prefill_slots, decode_slots)
                modes = self.sampling_table.mode_counts(self._active)
                sampled = bool(modes["sampled"] or modes["constrained"])
                constrained = modes["constrained"] > 0
                args = self._step_args(toks, pos, adv,
                                       ctr if sampled else None, constrained,
                                       verify=verify)
            if args.mask_s is not None:
                self.ledger.book("sample_mask", args.mask_s)
            t0 = self.clock.now()
            attempts = self.config.dispatch_retries + 1
            last_err = None
            out = None
            tc0 = tc1 = None
            for attempt in range(attempts):
                if self.ledger is not None:
                    # re-armed an attempt: a failed attempt's time stays
                    # in the host phase; only the successful one's span is
                    # booked as compute
                    tc0 = self.clock.now()
                try:
                    out = self._run_dispatch(kinds, self._attempt(args))
                    if tc0 is not None:
                        tc1 = self.clock.now()
                except DispatchFailedError as e:
                    last_err = e
                    self.metrics.on_dispatch_failure(e.reason)
                    flight_recorder().record(
                        "dispatch_retry", engine="llm", attempt=attempt + 1,
                        attempts=attempts, reason=e.reason,
                        prefill_rows=len(prefill_slots),
                        decode_rows=len(decode_slots))
                    _log.warning(
                        "unified step dispatch failed over %d prefill + %d "
                        "decode row(s) (attempt %d/%d): %s",
                        len(prefill_slots), len(decode_slots), attempt + 1,
                        attempts, e)
                    continue
                if decode_slots:
                    # the breaker tracks engine-level (decode) failures; a
                    # prefill-only success must not launder a streak
                    self.supervisor.record_success()
                break
            else:
                if self._blame_and_quarantine(args, constrained):
                    continue    # survivors retry on a rebuilt row set
                self._fail_all_active(attempts, last_err)
                self.supervisor.record_failure()
                return 0
            with self._cond:
                accept = self._acceptance_locked(decode_slots, spec_drafts,
                                                 out[0])
            if tc1 is not None:
                self._book_dispatch(args, tc1 - tc0, prefill_slots, accept)
            return self._commit(args, out, prefill_slots, decode_slots,
                                accept, t0)

    def _book_dispatch(self, args: _StepArgs, seconds: float,
                       prefill_slots, accept):
        """Book one successful step's span into the ledger, split by
        useful positions (each prefill row's chunk, each decode row's
        emitted tokens) and apportioned to the rows' tenants and SLO
        classes; a verify row's rejected columns stay in the step's total
        positions only, as pad waste. The windows' drafted and accepted
        counts go with it. An armed engine re-buckets the same shares by
        adapter id ("base" for row 0), so per-adapter seconds sum to the
        tenants'."""
        drafted = accepted = 0
        with self._cond:
            rows = [(self._active[s], int(args.adv[s]))
                    for s in prefill_slots if s in self._active]
            decoded = []
            for s, (emit, acc, k) in accept.items():
                req = self._active.get(s)
                if req is None:
                    continue
                decoded.append((req, len(emit)))
                drafted += k
                accepted += acc
        rows += decoded
        self.ledger.book_dispatch(
            seconds,
            prefill_positions=int(sum(args.adv[s] for s in prefill_slots)),
            decode_positions=sum(n for _, n in decoded),
            total_positions=int(args.toks.size),
            owners=[(r.tenant, r.slo, n) for r, n in rows],
            drafted=drafted, draft_accepted=accepted,
            adapter_owners=([(r.adapter or "base", n) for r, n in rows]
                            if self.adapter_bank is not None else None))

    def _commit(self, args: _StepArgs, out, prefill_slots, decode_slots,
                accept, t0: float) -> int:
        """Commit a successful step: lengths, streams, TTFT, retirements
        and the step's metrics, booked once for the committed step. A
        decode row commits the tokens `accept` gives it: the target length
        grows by them (the verify's rejected columns lie past it) and its
        draft row rewinds to the same length."""
        nxt, lps, new_dstate = out
        adv, pos = args.adv, args.pos
        if args.sampled:
            self.metrics.on_mask_overhead(args.mask_ms)
        self.steps += 1
        now = self.clock.now()
        total_emitted = 0
        with self._cond:
            if decode_slots:
                self.decode_iterations += 1
            elif prefill_slots:
                self.prefill_dispatches += 1
            for slot in prefill_slots:
                req = self._active.get(slot)
                if req is None:
                    continue
                n = int(adv[slot])
                off = req.chunk_off
                self.pool.set_length(slot, off + n)
                req.chunk_off = off + n
                self.prefill_tokens += n
                if req.trace is not None:
                    req.trace.event("prefill_chunk", now, off=off, n=n)
                if req.chunk_off >= len(req.prompt):
                    # final chunk landed: first token emitted, TTFT ends
                    req.handle.ttft_ms = (now - req.arrival) * 1e3
                    if req.trace is not None:
                        # the instant of ttft_ms, so the two reconcile
                        req.trace.mark("first_token", now)
                    self.metrics.on_prefill(req.handle.ttft_ms, slo=req.slo)
                    if self.burn is not None:
                        target = (self.config.slo_ttft_target_ms
                                  or {}).get(req.slo)
                        self.burn.observe(
                            req.slo,
                            target is None or req.handle.ttft_ms <= target,
                            outcome="ttft")
                    if self.prefix_cache is not None:
                        # index the prefill while the slot is active, so
                        # requests queued behind it attach at once
                        self.prefix_cache.insert(
                            self._kv_ns(req.tenant, req.adapter),
                            req.prompt, slot, req.attached_pages)
                    self._emit(req, slot, nxt[slot, n - 1],
                               lps[slot, n - 1], new_dstate)
                    if self._finish_if_done(req, now):
                        del self._active[slot]
                    elif req.deadline is not None and now >= req.deadline:
                        self._evict_expired_locked(req, slot, now)
                elif req.deadline is not None and now >= req.deadline:
                    # mid-prefill eviction: the slot must not keep
                    # absorbing chunk work
                    self._evict_expired_locked(req, slot, now)
            for slot in decode_slots:
                req = self._active.get(slot)
                if req is None or slot not in accept:
                    continue
                emit, acc, k = accept[slot]
                length = int(pos[slot]) + len(emit)
                self.pool.set_length(slot, length)
                ds = req.draft_slot
                if ds is not None and self.draft_pool.active[ds]:
                    # the draft ran ahead on its own proposals: back to
                    # the verified stream, so the next window extends it
                    self.draft_pool.rewind_length(
                        ds, min(int(self.draft_pool.lengths[ds]), length))
                if req.trace is not None:
                    ev = dict(tok=emit[-1], n_active=len(decode_slots))
                    if k:
                        ev.update(drafted=k, accepted=acc)
                    req.trace.event("decode_step", now, **ev)
                for j, tok in enumerate(emit):
                    self._emit(req, slot, tok, lps[slot, j], new_dstate)
                total_emitted += len(emit)
                if k:
                    self.spec_windows += 1
                    self.spec_drafted += k
                    self.spec_accepted += acc
                    self.metrics.on_spec_window(k, acc)
                if self._finish_if_done(req, now):
                    del self._active[slot]
                elif req.deadline is not None and now >= req.deadline:
                    self._evict_expired_locked(req, slot, now)
            self.metrics.set_slots(self.pool.active_slots(),
                                   self.pool.num_slots)
            self.metrics.set_sample_slots(
                self.sampling_table.mode_counts(self._active))
        if decode_slots:
            self.metrics.on_decode_step(len(decode_slots), (now - t0) * 1e3,
                                        tokens=total_emitted)
            return 1
        return 0

    def _blame_and_quarantine(self, args: _StepArgs,
                              constrained: bool) -> bool:
        """Step retries exhausted: probe each active request alone, with
        the step's own operands for its row and every other row masked as
        a free slot is (toks 0, adv 0, pos = capacity: their writes land
        in the slabs' pad region; the JAX probe's pos = 0 would overwrite
        every survivor's positions 0..C-1), announced as that request's
        kind ("prefill" for a row still in chunked prefill, else
        "decode"); quarantine the rows whose probe fails. Probe results
        are discarded, so survivors' streams and KV stay those of a
        fault-free run. When every probe of a multi-row step fails, no
        one request explains the failure: return False and let the
        breaker own it. A single-row step whose probe fails is
        quarantined."""
        with self._cond:
            suspects = list(self._active.items())
        blamed = []
        for slot, req in suspects:
            solo_toks, solo_pos, solo_adv = self._probe_rows(args, slot)
            solo_ctr = solo_verify = None
            if args.sampled:
                solo_ctr = np.zeros_like(args.pos)
                solo_ctr[slot] = req.sample_offset + len(req.emitted)
            if args.verify is not None:
                solo_verify = np.zeros_like(args.verify)
                solo_verify[slot] = args.verify[slot]
            kind = ("prefill" if req.chunk_off < len(req.prompt)
                    else "decode")
            probe_kinds = [(kind, (req.submit_idx,))]
            solo_rows = None
            if self.adapter_bank is not None:
                # the probed row keeps its real bank row, so an adapter-
                # scoped fault reproduces in isolation; it announces the
                # adapter kind the full step did
                solo_rows = np.zeros(len(args.pos), np.int64)
                solo_rows[slot] = self.adapter_bank.slot_row(slot)
                if req.adapter:
                    probe_kinds.append(("adapter", (req.submit_idx,)))
            with self._cond:
                # the real sampling operands: a fault that reproduces only
                # under the row's grammar mask or sampled lane must still
                # be attributable
                pargs = self._step_args(solo_toks, solo_pos, solo_adv,
                                        solo_ctr, constrained, solo_rows,
                                        verify=solo_verify)
            try:
                self._run_dispatch(tuple(probe_kinds), self._attempt(pargs))
            except DispatchFailedError as e:
                blamed.append((slot, req, e))
                flight_recorder().record(
                    "solo_probe", engine="llm", rid=req.rid,
                    submit_idx=req.submit_idx, stage=kind,
                    outcome="failed")
            else:
                flight_recorder().record(
                    "solo_probe", engine="llm", rid=req.rid,
                    submit_idx=req.submit_idx, stage=kind, outcome="ok")
        if not blamed or (len(blamed) == len(suspects) and len(suspects) > 1):
            return False
        with self._cond:
            for slot, req, e in blamed:
                if slot not in self._active:
                    continue
                self._conclude(req, "quarantined")
                req.handle.future.set_exception(DispatchFailedError(
                    f"request {req.submit_idx} quarantined: its rows "
                    f"reproduce the decode failure in isolation ({e})",
                    reason="poisoned"))
                self.metrics.on_fail()
                self.metrics.on_quarantine()
                flight_recorder().record(
                    "quarantine", engine="llm", rid=req.rid,
                    submit_idx=req.submit_idx, reason="poisoned",
                    tokens_emitted=len(req.emitted))
                self._free_slot_locked(slot, req)
                del self._active[slot]
            self.metrics.set_slots(self.pool.active_slots(),
                                   self.pool.num_slots)
            self.metrics.set_sample_slots(
                self.sampling_table.mode_counts(self._active))
        self.supervisor.absolve()
        _log.warning("quarantined %d poisoned request(s); retrying the "
                     "unified step with %d survivor(s)", len(blamed),
                     len(suspects) - len(blamed))
        return True

    def _probe_rows(self, args: _StepArgs, slot: int):
        """(toks, pos, adv) of the blame probe of `slot`: its row of the
        step, every other row masked as a free slot is (toks 0, adv 0,
        pos = capacity, so its stripe lands in the pad region)."""
        toks = np.zeros_like(args.toks)
        pos = np.full_like(args.pos, self.pool.capacity)
        adv = np.zeros_like(args.adv)
        toks[slot] = args.toks[slot]
        pos[slot] = args.pos[slot]
        adv[slot] = args.adv[slot]
        return toks, pos, adv

    def _fail_all_active(self, attempts: int, last_err):
        """A step failure no single request explains: fail every active
        request with a typed error (partial tokens stay readable) and free
        their slots; the caller charges the circuit breaker."""
        with self._cond:
            n_failed = len(self._active)
            for slot, req in list(self._active.items()):
                self._conclude(req, "failed:engine")
                req.handle.future.set_exception(DispatchFailedError(
                    f"decode dispatch failed {attempts} consecutive times; "
                    f"{len(req.emitted)} of {req.max_new_tokens} tokens "
                    f"emitted ({last_err})", reason="engine"))
                self.metrics.on_fail()
                # observed before the caller charges the breaker, so a
                # burn crossing lands in the flight ring ahead of the
                # breaker_open event it predicts
                if self.burn is not None:
                    self.burn.observe(req.slo, False,
                                      outcome="engine_failure")
                self._free_slot_locked(slot, req)
            self._active.clear()
            self.metrics.set_slots(self.pool.active_slots(),
                                   self.pool.num_slots)
            self.metrics.set_sample_slots(
                self.sampling_table.mode_counts(self._active))
        flight_recorder().record(
            "engine_failure", engine="llm", failed=n_failed,
            attempts=attempts, error=str(last_err))

    def _evict_expired_locked(self, req: _GenRequest, slot: int,
                              now: float):
        """Deadline eviction of an active row (mid-prefill or mid-decode);
        partial tokens stay readable on the handle."""
        stage = ("mid-prefill" if req.chunk_off < len(req.prompt)
                 else "mid-decode")
        self._conclude(req, f"expired:{stage}", now)
        req.handle.future.set_exception(DeadlineExceededError(
            f"deadline expired after {len(req.emitted)} of "
            f"{req.max_new_tokens} tokens (evicted {stage})"))
        self.metrics.on_expire()
        if self.burn is not None:
            self.burn.observe(req.slo, False, outcome="deadline")
        self._free_slot_locked(slot, req)
        del self._active[slot]

    def _free_slot_locked(self, slot: int, req: _GenRequest):
        """Free a slot's pool row and its request's draft row, reset the
        slot's sampling row to greedy and its adapter row to 0. Every
        terminal path comes here, so the draft pool's slot ledger follows
        the target's."""
        self.pool.free(slot)
        self.sampling_table.clear(slot)
        if self.adapter_bank is not None:
            self.adapter_bank.clear_slot(slot)
        if self.draft_pool is not None and req.draft_slot is not None:
            if self.draft_pool.active[req.draft_slot]:
                self.draft_pool.free(req.draft_slot)
            req.draft_slot = None

    def _emit(self, req: _GenRequest, slot: int, tok: int, lp: float,
              new_dstate: Optional[np.ndarray]):
        """Append one selected token (and its logprob) to the slot's
        stream; a constrained row commits the DFA state the step
        advanced past it."""
        tok = int(tok)
        req.emitted.append(tok)
        req.last_tok = tok
        req.handle._append(tok, float(lp) if req.want_logprobs else None)
        if req.gid > 0:
            self.sampling_table.set_dfa_state(slot, int(new_dstate[slot]))
            self.metrics.on_sample_token("constrained")
        elif req.sampling is not None and req.sampling.do_sample:
            self.metrics.on_sample_token("sampled")
        if self.adapter_bank is not None:
            self.metrics.on_adapter_token(req.adapter or "base")

    def _finish_if_done(self, req: _GenRequest, now: float) -> bool:
        """Retire a request whose last token ended it (EOS, max tokens,
        or for a constrained request a terminal DFA state: accepting with
        no legal continuation) and free its slot."""
        done = (len(req.emitted) >= req.max_new_tokens
                or (req.eos_token_id is not None
                    and req.emitted[-1] == req.eos_token_id)
                or (req.gid > 0 and req.slot is not None
                    and self.sampling_table.is_terminal(
                        req.gid,
                        int(self.sampling_table.dfa_state[req.slot]))))
        if not done:
            return False
        # the timeline is finished before the future resolves: a waiter
        # woken by result() finds it complete
        self._conclude(req, "completed", now)
        req.handle.future.set_result(np.asarray(req.emitted, np.int32))
        self.metrics.on_complete((now - req.arrival) * 1e3, slo=req.slo,
                                 tenant=req.tenant)
        if req.slot is not None and self.pool.active[req.slot]:
            self._free_slot_locked(req.slot, req)
        return True

    # ---- scheduler thread ----
    def _scheduler_main(self):
        while True:
            with self._cond:
                while True:
                    if self._stopped or self.supervisor.open:
                        return
                    if (self._draining and not self._queue_len_locked()
                            and not self._active):
                        return          # drained: stop() joins us
                    if self._queue_len_locked() or self._active:
                        break
                    self.clock.wait(self._cond, None)
            try:
                self.pump()
            except Exception as e:
                # the black box records the unhandled pump exception
                # before the scheduler carries on
                fr = flight_recorder()
                fr.record("pump_exception", engine="llm",
                          error=f"{type(e).__name__}: {e}")
                fr.try_dump(reason="pump_exception:llm")
                _log.exception("llm scheduler pump failed; continuing")
