"""Per-slot seeded sampling and grammar-constrained decoding (counterpart
of paddle_tpu/serving/llm/sampling.py).

Everything a request can ask for (temperature, top-k, top-p, a seed, a
JSON-schema grammar) rides through the engine's unified step as per-slot
tensors, beside the slot's row of a fixed-shape grammar bank. Three
pieces, each the port's own copy of the reference's:

* `SamplingParams`, the request-level contract. A request samples iff
  `seed is not None`. Token `i` of a seeded stream is drawn with the key
  `lane_key(seed, i) = fold_in(fold_in(PRNGKey(0), seed), i)` on JAX's
  threefry (`core.threefry`), a function of (seed, i) alone: a stream is
  the same whatever its batch-mates, slot or engine, and resumes at
  `sample_offset` after a re-prefill.

* A JSON-schema subset -> char NFA -> char DFA -> token DFA compiler
  (`compile_grammar`), lifted against the request's token table
  (token id -> text), with EOS legal exactly in accepting states and
  dead states pruned to a fixpoint. It runs on the host, in numpy.

* The selection: `select_tokens` over a step's [N, C, V] logits, as the
  reference computes it (grammar mask, then `_select_token`'s per-row
  branch on per-(row, column) lane keys, the DFA advanced at the
  emission column), `select_next` for a draft's [N, V] logits, and
  `select_rows`, one emission a row, which the port's engine runs.

Selection is plain PyTorch on the device of the logits: the JAX package
computes it in XLA, outside any Pallas kernel.
"""
from __future__ import annotations

import functools
import json
import threading
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ...core import threefry
from ...models.generation import _NEG, _select_token

# char-DFA subset-construction blowup guard; schemas in the supported
# subset are tiny (tens of states) — hitting this means a pathological
# enum/nesting, better rejected at admission than OOMing the bank
_MAX_CHAR_STATES = 4096


# ---------------------------------------------------------------------------
# request-level params
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling contract carried to the slot.

    `seed is None` -> greedy (the default; bit-identical to the
    pre-sampling engine). `grammar`, when set, is a dict
    `{"schema": <json-schema subset>, "tokens": {token_id: text}}`;
    constrained decoding works for greedy and sampled requests alike.
    """
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    grammar: Optional[dict] = None

    @property
    def do_sample(self) -> bool:
        return self.seed is not None

    @property
    def constrained(self) -> bool:
        return self.grammar is not None

    def validate(self):
        if not (float(self.temperature) > 0.0):
            raise ValueError(
                f"temperature must be > 0, got {self.temperature}")
        if int(self.top_k) < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not (0.0 < float(self.top_p) <= 1.0):
            raise ValueError(
                f"top_p must be in (0, 1], got {self.top_p}")
        if self.seed is not None and not (
                0 <= int(self.seed) < 2 ** 31):
            raise ValueError(f"seed must be a non-negative int31, "
                             f"got {self.seed}")
        if self.grammar is not None:
            if (not isinstance(self.grammar, dict)
                    or "schema" not in self.grammar
                    or "tokens" not in self.grammar):
                raise ValueError(
                    "grammar must be {'schema': ..., 'tokens': "
                    "{token_id: text}}")
        return self

    def grammar_key(self) -> Optional[str]:
        """Canonical intern key for the compiled-DFA bank."""
        if self.grammar is None:
            return None
        return json.dumps(self.grammar, sort_keys=True)

    @classmethod
    def from_payload(cls, body: Mapping) -> Optional["SamplingParams"]:
        """Build from a /generate JSON payload; None when the request
        carries no sampling field at all (pure greedy fast path)."""
        fields = ("temperature", "top_k", "top_p", "seed", "grammar")
        if not any(f in body for f in fields):
            return None
        grammar = body.get("grammar")
        if grammar is not None and isinstance(grammar.get("tokens"), dict):
            # JSON object keys arrive as strings; token ids are ints
            grammar = dict(grammar)
            grammar["tokens"] = {int(k): str(v)
                                 for k, v in grammar["tokens"].items()}
        return cls(
            temperature=float(body.get("temperature", 1.0)),
            top_k=int(body.get("top_k", 0)),
            top_p=float(body.get("top_p", 1.0)),
            seed=(None if body.get("seed") is None
                  else int(body["seed"])),
            grammar=grammar,
        ).validate()


GREEDY = SamplingParams()


# ---------------------------------------------------------------------------
# JSON-schema subset -> char NFA -> char DFA
# ---------------------------------------------------------------------------

class _NFA:
    def __init__(self):
        self.n = 0
        self.eps: Dict[int, set] = {}
        self.edges: Dict[int, Dict[str, set]] = {}

    def state(self) -> int:
        s = self.n
        self.n += 1
        return s

    def add_eps(self, a, b):
        self.eps.setdefault(a, set()).add(b)

    def add_edge(self, a, ch, b):
        self.edges.setdefault(a, {}).setdefault(ch, set()).add(b)

    def literal(self, text: str):
        """Chain of states consuming `text`; returns (start, end)."""
        start = cur = self.state()
        for ch in text:
            nxt = self.state()
            self.add_edge(cur, ch, nxt)
            cur = nxt
        return start, cur


def _json_string_literal(value) -> str:
    return json.dumps(value, ensure_ascii=False)


def _frag(nfa: _NFA, schema: dict):
    """Compile one schema node to an NFA fragment (start, end)."""
    if not isinstance(schema, dict):
        raise ValueError(f"unsupported schema node: {schema!r}")
    if "const" in schema:
        return nfa.literal(_json_string_literal(schema["const"]))
    if "enum" in schema:
        start, end = nfa.state(), nfa.state()
        for v in schema["enum"]:
            s, e = nfa.literal(_json_string_literal(v))
            nfa.add_eps(start, s)
            nfa.add_eps(e, end)
        return start, end
    typ = schema.get("type")
    if typ == "string":
        raise ValueError(
            "free-form strings are not DFA-boundable; constrain with "
            "'enum' or 'const'")
    if typ == "boolean":
        return _frag(nfa, {"enum": [True, False]})
    if typ == "integer" or typ == "number":
        # -?(0|[1-9][0-9]*) — JSON-canonical integers; 'number' shares
        # the integer grammar (fractions are out of the subset)
        start, end = nfa.state(), nfa.state()
        body = nfa.state()
        nfa.add_eps(start, body)
        nfa.add_edge(start, "-", body)
        nfa.add_edge(body, "0", end)
        loop = nfa.state()
        for d in "123456789":
            nfa.add_edge(body, d, loop)
        for d in "0123456789":
            nfa.add_edge(loop, d, loop)
        nfa.add_eps(loop, end)
        return start, end
    if typ == "object":
        props = schema.get("properties", {})
        if not props:
            return nfa.literal("{}")
        start, cur = nfa.literal("{")
        first = True
        # properties are required and emitted in declared order: the
        # canonical serialization a constrained emitter produces
        for name, sub in props.items():
            prefix = ("" if first else ",") + _json_string_literal(
                str(name)) + ":"
            first = False
            ps, pe = nfa.literal(prefix)
            nfa.add_eps(cur, ps)
            vs, ve = _frag(nfa, sub)
            nfa.add_eps(pe, vs)
            cur = ve
        cs, ce = nfa.literal("}")
        nfa.add_eps(cur, cs)
        return start, ce
    if typ == "array":
        items = schema.get("items")
        if items is None:
            raise ValueError("array schema requires 'items'")
        start, cur = nfa.literal("[")
        end = nfa.state()
        min_items = int(schema.get("minItems", 0))
        if min_items == 0:
            nfa.add_eps(cur, end)    # empty array
        s0, e0 = _frag(nfa, items)
        nfa.add_eps(cur, s0)
        sep_s, sep_e = nfa.literal(",")
        nfa.add_eps(e0, sep_s)
        s1, e1 = _frag(nfa, items)
        nfa.add_eps(sep_e, s1)
        nfa.add_eps(e1, sep_s)       # unbounded repetition
        nfa.add_eps(e0, end)
        nfa.add_eps(e1, end)
        cs, ce = nfa.literal("]")
        nfa.add_eps(end, cs)
        return start, ce
    raise ValueError(f"unsupported schema type: {typ!r}")


class _CharDFA:
    """Determinized char automaton: trans[(state, ch)] -> state,
    `accept` the set of accepting states, state 0 the start."""

    def __init__(self, trans, accept, n_states):
        self.trans = trans
        self.accept = accept
        self.n_states = n_states

    def run(self, state: int, text: str) -> int:
        """Advance `state` over `text`; -1 once any char is illegal."""
        for ch in text:
            state = self.trans.get((state, ch), -1)
            if state < 0:
                return -1
        return state


def _determinize(nfa: _NFA, start: int, end: int) -> _CharDFA:
    def closure(states):
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps.get(s, ()):
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    s0 = closure({start})
    ids = {s0: 0}
    order = [s0]
    trans: Dict[tuple, int] = {}
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        chars = set()
        for s in cur:
            chars.update(nfa.edges.get(s, {}))
        for ch in sorted(chars):
            nxt = set()
            for s in cur:
                nxt.update(nfa.edges.get(s, {}).get(ch, ()))
            nc = closure(nxt)
            if nc not in ids:
                if len(ids) >= _MAX_CHAR_STATES:
                    raise ValueError(
                        "grammar too large: char-DFA exceeds "
                        f"{_MAX_CHAR_STATES} states")
                ids[nc] = len(ids)
                order.append(nc)
            trans[(ids[cur], ch)] = ids[nc]
    accept = {ids[s] for s in order if end in s}
    return _CharDFA(trans, accept, len(ids))


# ---------------------------------------------------------------------------
# token lift
# ---------------------------------------------------------------------------

class TokenDFA:
    """Token-level DFA: `trans` [S, V] int32 (-1 = forbidden),
    `accept` [S] bool (EOS legal there, as a self-loop)."""

    __slots__ = ("trans", "accept", "n_states")

    def __init__(self, trans: np.ndarray, accept: np.ndarray):
        self.trans = trans
        self.accept = accept
        self.n_states = trans.shape[0]


def compile_grammar(grammar: dict, vocab_size: int,
                    eos_token_id: Optional[int]) -> TokenDFA:
    """Compile `{"schema":..., "tokens": {id: text}}` into a TokenDFA.

    Raises ValueError when the schema is outside the subset, the token
    table cannot realize it (start state dead after pruning), or EOS is
    required to terminate but the request has none."""
    schema = grammar["schema"]
    token_strs = grammar["tokens"]
    nfa = _NFA()
    start, end = _frag(nfa, schema)
    cdfa = _determinize(nfa, start, end)

    S = cdfa.n_states
    trans = np.full((S, vocab_size), -1, np.int32)
    for tid, text in token_strs.items():
        tid = int(tid)
        if not (0 <= tid < vocab_size):
            raise ValueError(f"grammar token id {tid} outside vocab "
                             f"[0, {vocab_size})")
        if not text:
            continue                  # empty-text tokens never legal
        for q in range(S):
            r = cdfa.run(q, text)
            if r >= 0:
                trans[q, tid] = r
    accept = np.zeros(S, bool)
    accept[list(cdfa.accept)] = True
    if eos_token_id is not None and 0 <= int(eos_token_id) < vocab_size:
        # EOS legal exactly at acceptance — emitting it finishes the
        # request, the self-loop keeps the mask well-formed afterwards
        trans[accept, int(eos_token_id)] = np.nonzero(accept)[0]
    elif not accept.any():
        raise ValueError("grammar has no accepting state")

    # prune dead states to a fixpoint: a state with no legal token is a
    # trap (if it accepts without EOS the stream merely stops early at
    # max_new_tokens — still only valid prefixes emitted — but a
    # non-accepting trap would force an illegal token, so transitions
    # into it must die too)
    changed = True
    while changed:
        changed = False
        live = (trans >= 0).any(axis=1) | accept
        for q in range(S):
            row = trans[q]
            bad = (row >= 0) & ~live[np.clip(row, 0, S - 1)]
            if bad.any():
                row[bad] = -1
                changed = True
    if not ((trans[0] >= 0).any() or accept[0]):
        raise ValueError(
            "grammar unsatisfiable with the given token table")
    return TokenDFA(trans, accept)


# ---------------------------------------------------------------------------
# per-slot table + stacked grammar bank
# ---------------------------------------------------------------------------

_BASE_KEY = threefry.prng_key(0)


def lane_key(seed, index):
    """The seeding contract: the key that draws stream token `index` of a
    request seeded `seed`, fold_in(fold_in(PRNGKey(0), seed), index).
    Vectorised over tensors of seeds and indices (on their device)."""
    seed = torch.as_tensor(seed)
    return threefry.fold_in(
        threefry.fold_in(_BASE_KEY.to(seed.device), seed), index)


@functools.lru_cache(maxsize=1024)
def _seed_key(seed: int) -> torch.Tensor:
    """fold_in(PRNGKey(0), seed) on the host, once per seed."""
    return threefry.fold_in(_BASE_KEY, seed)


class SlotSamplingTable:
    """Host-side per-slot sampling state, mirrored to `device` as per-slot
    tensors for the engine's step.

    The grammar bank is a fixed-shape [1 + max_grammars, max_dfa_states,
    V] int32 array (row 0 = pass-through: one state, every token legal,
    self-loop), as in the reference. Its device copy is made when a step
    first needs it and dropped when a compile lands a new row; the
    per-slot tensors are rebuilt only after a bind, a clear or a DFA
    commit. Each slot also keeps its request's seed key
    fold_in(PRNGKey(0), seed), so a step folds in only its stream index."""

    def __init__(self, num_slots: int, vocab_size: int,
                 max_grammars: int = 8, max_dfa_states: int = 128,
                 device=None):
        n = int(num_slots)
        self.vocab_size = int(vocab_size)
        self.max_grammars = int(max_grammars)
        self.max_dfa_states = int(max_dfa_states)
        self.device = torch.device("cpu" if device is None else device)
        self.temperature = np.ones(n, np.float32)
        self.top_k = np.zeros(n, np.int32)
        self.top_p = np.ones(n, np.float32)
        self.do_sample = np.zeros(n, bool)
        self.dfa_state = np.zeros(n, np.int32)
        self.grammar_id = np.zeros(n, np.int32)
        self.seed_key = torch.zeros((n, 2), dtype=torch.int64)
        self.bank = np.full(
            (1 + self.max_grammars, self.max_dfa_states, self.vocab_size),
            -1, np.int32)
        self.bank[0, 0, :] = 0
        self._interned: Dict[str, int] = {}
        self._dev_bank = None
        self._dev_args = None   # cached device copies of the per-slot arrays
        self._lock = threading.Lock()

    # -- grammar interning --
    def lookup(self, key: str) -> Optional[int]:
        """gid of an already-interned grammar, else None (the caller
        compiles outside the lock and calls intern)."""
        with self._lock:
            return self._interned.get(key)

    def intern(self, key: str, dfa: TokenDFA) -> int:
        with self._lock:
            gid = self._interned.get(key)
            if gid is not None:
                return gid
            if len(self._interned) >= self.max_grammars:
                raise ValueError(
                    f"grammar bank full ({self.max_grammars}); raise "
                    "max_grammars or retire grammars")
            if dfa.n_states > self.max_dfa_states:
                raise ValueError(
                    f"grammar needs {dfa.n_states} DFA states > "
                    f"max_dfa_states={self.max_dfa_states}")
            gid = len(self._interned) + 1
            self.bank[gid, :dfa.n_states, :] = dfa.trans
            self._interned[key] = gid
            self._dev_bank = None
            return gid

    @property
    def grammars_compiled(self) -> int:
        return len(self._interned)

    def is_terminal(self, gid: int, state: int) -> bool:
        """True when a constrained slot's grammar is fully emitted and
        has no legal continuation (an accepting trap with no EOS): the
        engine finishes the request rather than let the mask go empty."""
        return gid > 0 and not (self.bank[gid, state] >= 0).any()

    def device_bank(self) -> torch.Tensor:
        with self._lock:
            if self._dev_bank is None:
                self._dev_bank = torch.from_numpy(self.bank).to(self.device)
            return self._dev_bank

    def device_args(self):
        """Device copies of the 6 per-slot operand arrays (temperature,
        top_k, top_p, do_sample, dfa_state, grammar_id), rebuilt only
        when a slot binds or clears or a DFA state commits."""
        if self._dev_args is None:
            self._dev_args = tuple(
                torch.from_numpy(a.copy()).to(self.device)
                for a in (self.temperature, self.top_k, self.top_p,
                          self.do_sample, self.dfa_state, self.grammar_id))
        return self._dev_args

    def lane_keys(self, ctr: np.ndarray,
                  rows: Optional[np.ndarray] = None) -> torch.Tensor:
        """[R, 2] lane keys at stream indices `ctr [R]` of the slots
        `rows [R]` (every slot in order when None), folded on the host
        from the slots' seed keys and moved to the device:
        lane_key(seed, ctr) word for word."""
        seed_key = (self.seed_key if rows is None
                    else self.seed_key[torch.from_numpy(rows)])
        keys = threefry.fold_in(seed_key, torch.from_numpy(ctr))
        return keys.to(self.device)

    def set_dfa_state(self, slot: int, state: int):
        """Commit a constrained slot's advanced DFA state (the engine's
        post-step writeback). Mutating `dfa_state` directly would leave
        the device-args cache stale — always go through here."""
        self.dfa_state[slot] = int(state)
        self._dev_args = None

    # -- slot lifecycle --
    def bind(self, slot: int, params: SamplingParams, gid: int = 0,
             dfa_state: int = 0):
        p = params or GREEDY
        self.temperature[slot] = float(p.temperature)
        self.top_k[slot] = int(p.top_k)
        self.top_p[slot] = float(p.top_p)
        self.do_sample[slot] = bool(p.do_sample)
        # a greedy row's draw is discarded, so its key stays zero
        self.seed_key[slot] = (0 if p.seed is None
                               else _seed_key(int(p.seed)))
        self.grammar_id[slot] = int(gid)
        self.dfa_state[slot] = int(dfa_state)
        self._dev_args = None

    def clear(self, slot: int):
        self.bind(slot, GREEDY)

    def mode_counts(self, active_slots) -> Dict[str, int]:
        """Per-mode occupancy over the given active slot ids."""
        out = {"greedy": 0, "sampled": 0, "constrained": 0}
        for s in active_slots:
            if self.grammar_id[s] > 0:
                out["constrained"] += 1
            elif self.do_sample[s]:
                out["sampled"] += 1
            else:
                out["greedy"] += 1
        return out


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------

def select_rows(logits, keys, temperature, top_k, top_p, do_sample,
                dfa_state, grammar_id, bank=None):
    """One emission a row: [R, V] logits -> ([R] int32 tokens, [R] DFA
    states after them), each row drawn on its lane key `keys [R, 2]`.

    The reference's order: the grammar mask of the row's current state
    (-1e30 outside it) on fp32 logits, then `_select_token`'s per-row
    branch (temperature, top-k, top-p, categorical; masked argmax for
    greedy rows), then the DFA stepped over the chosen token. With
    `bank=None` no row is constrained: every row would ride the bank's
    pass-through row, so the mask and the DFA step are left out, which
    changes no token."""
    lg = logits.float()
    if bank is not None:
        allowed = bank[grammar_id.long(), dfa_state.long()] >= 0
        lg = torch.where(allowed, lg, _NEG)
    toks = _select_token(lg, do_sample, temperature, top_k, keys, top_p)
    if bank is None:
        return toks, dfa_state
    stepped = bank[grammar_id.long(), dfa_state.long(), toks.long()]
    return toks, torch.where(grammar_id > 0, stepped.clamp(min=0),
                             dfa_state)


def select_tokens(logits, adv, temperature, top_k, top_p, do_sample,
                  seed, ctr, dfa_state, grammar_id, bank):
    """[N, C, V] logits -> ([N, C] tokens, [N] new DFA states), every
    column selected as the reference's unified step selects it.

    `ctr[n]` is the stream index of row n's column 0 (column t draws on
    lane (seed, ctr + t)); the grammar mask of the row's current state
    applies to every column and the DFA advances at the emission column
    adv-1 of rows with adv > 0. The port's engine selects only the
    columns it consumes (each row's emission column, every column of a
    verify window) with `select_rows`; this whole-step form is the
    reference's."""
    N, C, V = logits.shape
    dev = logits.device

    def rep(a):
        return torch.as_tensor(a, device=dev).repeat_interleave(C)

    cols = torch.arange(C, device=dev)
    index = (torch.as_tensor(ctr, device=dev).long()[:, None]
             + cols).reshape(-1)
    keys = lane_key(rep(seed), index)
    toks, states = select_rows(
        logits.reshape(N * C, V), keys, rep(temperature), rep(top_k),
        rep(top_p), rep(do_sample), rep(dfa_state), rep(grammar_id), bank)
    toks, states = toks.reshape(N, C), states.reshape(N, C)
    adv = torch.as_tensor(adv, device=dev).long()
    emitted = states.gather(1, (adv - 1).clamp(min=0)[:, None])[:, 0]
    dfa_state = torch.as_tensor(dfa_state, device=dev)
    return toks, torch.where(adv > 0, emitted, dfa_state)


def select_next(logits, temperature, top_k, top_p, do_sample, seed, ctr,
                keys=None):
    """Width-1 selection for a draft's propose step: [N, V] logits -> [N]
    tokens drawn on the same lanes the target's verify uses, so a draft
    that agrees with the target proposes the target's own draw. `keys`
    ([N, 2]) are those lanes' keys already folded, lane_key(seed, ctr),
    as the engine folds them on the host before a propose; `seed` and
    `ctr` are then not read."""
    if keys is None:
        keys = lane_key(seed, ctr)
    return _select_token(logits, do_sample, temperature, top_k, keys, top_p)
