"""Move weights between the JAX package and the port, as numpy.

`load_jax_state(model, params)` copies the arrays of a JAX model's
`functional_state()[0]` — handed over as numpy, so this module needs no
JAX — into the port model's parameters of the same names. The map is the
identity: the port keeps the JAX package's parameter names and layouts
(Paddle's `[in, out]` Linear weights included). Each array is cast to the
parameter's dtype and device. `export_state(model)` goes the other way,
so tests can compare parameters after training steps.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def load_jax_state(model: torch.nn.Module,
                   params: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy `params` into `model` in place and return it. Raises KeyError
    on a missing or extra key and ValueError on a shape mismatch, naming
    every offending key."""
    named = dict(model.named_parameters())
    missing = sorted(set(named) - set(params))
    extra = sorted(set(params) - set(named))
    if missing or extra:
        raise KeyError(f"JAX state does not match the port model: missing "
                       f"{missing}, extra {extra}")
    bad = [f"{k}: jax {tuple(np.shape(params[k]))} vs port "
           f"{tuple(p.shape)}" for k, p in named.items()
           if tuple(np.shape(params[k])) != tuple(p.shape)]
    if bad:
        raise ValueError("shape mismatch: " + "; ".join(bad))
    with torch.no_grad():
        for k, p in named.items():
            arr = np.array(params[k], dtype=np.float32)  # owned copy
            p.copy_(torch.from_numpy(arr).to(device=p.device, dtype=p.dtype))
    return model


def export_state(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """{name: float32 numpy copy} of every parameter (bf16 widened)."""
    return {k: p.detach().float().cpu().numpy().copy()
            for k, p in model.named_parameters()}
