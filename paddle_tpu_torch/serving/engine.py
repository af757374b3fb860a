"""Serving error vocabulary (counterpart of paddle_tpu/serving/engine.py:52-68).

The batching predictor engine itself waits for the serving front-end
slice; the LLM engine needs only these two errors.
"""
from __future__ import annotations


class RejectedError(RuntimeError):
    """Admission control fast-fail. `reason` is machine-readable and
    matches the reject-reason metric label ("queue_full", "shed",
    "draining", "prompt_too_long", "drain_timeout", "shutdown",
    "grammar_capacity", "tenant_quota")."""

    def __init__(self, msg: str, reason: str = "rejected"):
        super().__init__(msg)
        self.reason = reason


class DeadlineExceededError(TimeoutError):
    """The request's deadline expired while queued (dropped before
    dispatch) or while it held a slot (evicted)."""
