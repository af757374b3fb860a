"""LoRA adapter definition and injection for GPT and Llama fine-tuning
(counterpart of paddle_tpu/tuning/lora.py).

Low-rank deltas ``scaling * (x @ A^T @ B^T)`` are injected on the
attention and MLP projections of each decoder layer. Injection freezes
every base parameter (``requires_grad=False``), so the train steps
(`parallel.ScanTrainStep`, `ShardedTrainStep`), which train only the
parameters that require a gradient, update only the adapter leaves: the
counterpart of the JAX `functional_state()` holding only them.

The canonical adapter tree (what `adapter_state_dict` emits and the
serving `AdapterBank` consumes) is host numpy, float32::

    {"0": {"qkv_proj": {"A": [r, in], "B": [out, r]}, ...}, "1": {...}}

keyed by decoder-layer index, then target-site name. The same tree
crosses to and from the JAX package as it is.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..nn.layer.layers import Layer, create_parameter
from ..ops.lora import lora_matmul

GPT_TARGETS = ("qkv_proj", "out_proj", "linear1", "linear2")
LLAMA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                 "gate_proj", "up_proj", "down_proj")


@dataclass
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: Optional[Tuple[str, ...]] = None  # None = all sites of the arch
    init_std: float = 0.02

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f"LoRA rank must be >= 1, got {self.rank}")
        if self.alpha <= 0:
            raise ValueError(f"LoRA alpha must be > 0, got {self.alpha}")
        if self.targets is not None:
            self.targets = tuple(self.targets)


class LoRALinear(Layer):
    """Wraps a linear projection (`Linear`, `ColumnParallelLinear`,
    `RowParallelLinear`: weight `[in, out]`) with a trainable low-rank
    residual. `lora_A` `[r, in]` is drawn from Normal(0, init_std) with
    `generator`; `lora_B` `[out, r]` starts at zero, so the wrapped module
    is exactly the base projection until training moves it. Both are
    fp32 on the base weight's device."""

    def __init__(self, base, rank, alpha, init_std=0.02,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.base = base
        w = _base_weight(base)
        in_f, out_f = int(w.shape[0]), int(w.shape[1])
        self.rank, self.alpha = int(rank), float(alpha)
        self.scaling = self.alpha / self.rank
        self.lora_A = create_parameter([self.rank, in_f], w.device,
                                       torch.float32)
        self.lora_B = create_parameter([out_f, self.rank], w.device,
                                       torch.float32)
        with torch.no_grad():
            self.lora_A.normal_(0.0, init_std, generator=generator)
            self.lora_B.zero_()

    def forward(self, x):
        y = self.base(x)
        delta = (lora_matmul(x, self.lora_A, self.lora_B)
                 * self.scaling).to(x.dtype)
        return y + delta


def _base_weight(module):
    base = module.base if isinstance(module, LoRALinear) else module
    if not hasattr(base, "weight"):
        raise TypeError(f"LoRA target {type(base).__name__} has no weight")
    return base.weight


def _decoder_layers(model):
    """-> (list of decoder layers, arch name 'gpt'|'llama')."""
    if hasattr(model, "gpt"):
        return list(model.gpt.layers), "gpt"
    if hasattr(model, "llama"):
        return list(model.llama.layers), "llama"
    if hasattr(model, "layers"):
        layers = list(model.layers)
        if layers and hasattr(layers[0].self_attn, "qkv_proj"):
            return layers, "gpt"
        return layers, "llama"
    raise TypeError(f"cannot locate decoder layers on {type(model).__name__}")


def default_lora_targets(model) -> Tuple[str, ...]:
    _, arch = _decoder_layers(model)
    return GPT_TARGETS if arch == "gpt" else LLAMA_TARGETS


def _site_owner(layer, name, arch):
    """The module owning a target projection within a decoder layer."""
    if arch == "gpt":
        owner = layer.self_attn if name in ("qkv_proj", "out_proj") else layer
    else:
        owner = (layer.self_attn
                 if name in ("q_proj", "k_proj", "v_proj", "o_proj")
                 else layer.mlp)
    if not hasattr(owner, name):
        raise ValueError(f"unknown LoRA target {name!r} for arch {arch!r}")
    return owner


def target_sites(model, targets=None):
    """Per-decoder-layer dims of each target site: (list over layers of
    {site: (in_dim, out_dim)}, arch). Raises if layers disagree on a
    site's dims (the stacked serving bank needs a homogeneous stack)."""
    layers, arch = _decoder_layers(model)
    targets = tuple(targets) if targets else (
        GPT_TARGETS if arch == "gpt" else LLAMA_TARGETS)
    sites: List[Dict[str, Tuple[int, int]]] = []
    for layer in layers:
        dims = {}
        for name in targets:
            w = _base_weight(getattr(_site_owner(layer, name, arch), name))
            dims[name] = (int(w.shape[0]), int(w.shape[1]))
        sites.append(dims)
    for dims in sites[1:]:
        if dims != sites[0]:
            raise ValueError("LoRA target dims differ across decoder layers; "
                             "a stacked adapter bank requires homogeneous "
                             f"layers, got {dims} vs {sites[0]}")
    return sites, arch


def synthetic_adapter_tree(sites, seed, rank, sigma):
    """A synthetic adapter in the canonical layout over `sites` (the first
    value of `target_sites`, of a model of either package): A and B both
    ``sigma * randn`` from numpy's RandomState(seed), layer by layer and
    site by site, A before B. B is nonzero, so the delta moves tokens (a
    freshly injected adapter has B = 0 and no delta)."""
    r = np.random.RandomState(seed)
    return {str(i): {name: {"A": (sigma * r.randn(rank, io[0])
                                  ).astype(np.float32),
                            "B": (sigma * r.randn(io[1], rank)
                                  ).astype(np.float32)}
                     for name, io in layer.items()}
            for i, layer in enumerate(sites)}


def adapter_signature(model, rank, alpha=None, targets=None) -> dict:
    """JSON-serializable signature binding an adapter to its base model,
    shipped inside the `AdapterWeightSet` manifest and compared (typed
    refusal) against the serving bank before a row load."""
    sites, arch = target_sites(model, targets)
    return {
        "arch": arch,
        "num_layers": len(sites),
        "rank": int(rank),
        "alpha": None if alpha is None else float(alpha),
        "targets": sorted(sites[0].keys()),
        "dims": {name: [int(i), int(o)] for name, (i, o) in
                 sorted(sites[0].items())},
    }


def inject_lora(model, config: LoRAConfig,
                generator: Optional[torch.Generator] = None):
    """Freeze every existing parameter and wrap the target projections,
    layer by layer and site by site in the JAX order, each `lora_A`
    drawn from `generator` (a torch.Generator on the model's device,
    seeded 0 when None). Returns the (mutated) model: its trainable
    parameters are then only the `lora_A`/`lora_B` leaves."""
    layers, arch = _decoder_layers(model)
    targets = config.targets or (GPT_TARGETS if arch == "gpt"
                                 else LLAMA_TARGETS)
    if generator is None:
        device = next(model.parameters()).device
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    for p in model.parameters():
        p.requires_grad_(False)
    for layer in layers:
        for name in targets:
            owner = _site_owner(layer, name, arch)
            current = getattr(owner, name)
            if isinstance(current, LoRALinear):
                raise ValueError(f"LoRA already injected at {name!r}")
            setattr(owner, name, LoRALinear(current, config.rank,
                                            config.alpha, config.init_std,
                                            generator=generator))
    return model


def _iter_adapted_sites(model):
    layers, arch = _decoder_layers(model)
    for i, layer in enumerate(layers):
        for name in (GPT_TARGETS if arch == "gpt" else LLAMA_TARGETS):
            try:
                owner = _site_owner(layer, name, arch)
            except ValueError:
                continue
            module = getattr(owner, name, None)
            if isinstance(module, LoRALinear):
                yield i, name, module


def lora_parameters(model):
    """The trainable adapter parameters (feed these to the optimizer)."""
    out = []
    for _, _, module in _iter_adapted_sites(model):
        out.extend([module.lora_A, module.lora_B])
    return out


def adapter_state_dict(model) -> Dict[str, Dict[str, Dict[str, np.ndarray]]]:
    """The canonical adapter tree (host numpy, float32)."""
    tree: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
    for i, name, module in _iter_adapted_sites(model):
        tree.setdefault(str(i), {})[name] = {
            "A": module.lora_A.detach().float().cpu().numpy().copy(),
            "B": module.lora_B.detach().float().cpu().numpy().copy(),
        }
    if not tree:
        raise ValueError("model has no injected LoRA adapters")
    return tree


def load_adapter_state(model, tree):
    """Load a canonical adapter tree into an injected model, in place (the
    parameters keep their storage, so an optimizer's references hold)."""
    seen = []
    for i, name, module in _iter_adapted_sites(model):
        entry = tree.get(str(i), {}).get(name)
        if entry is None:
            raise ValueError(f"adapter tree missing layer {i} site {name!r}")
        A, B = np.asarray(entry["A"]), np.asarray(entry["B"])
        if A.shape != tuple(module.lora_A.shape) or \
                B.shape != tuple(module.lora_B.shape):
            raise ValueError(
                f"adapter shape mismatch at layer {i} site {name!r}: "
                f"{A.shape}/{B.shape} vs {tuple(module.lora_A.shape)}/"
                f"{tuple(module.lora_B.shape)}")
        seen.append((module, A, B))
    if not seen:
        raise ValueError("model has no injected LoRA adapters")
    with torch.no_grad():
        for module, A, B in seen:
            for p, v in ((module.lora_A, A), (module.lora_B, B)):
                p.copy_(torch.from_numpy(np.array(v, np.float32)).to(
                    device=p.device, dtype=p.dtype))
    return model


def merge_adapter_delta(model):
    """Fold each adapter delta into its base weight (serving without a
    bank): W [in, out] += scaling * A^T B^T in fp32, cast back to W's
    dtype; the LoRA residual is then zeroed, so the wrapped module keeps
    producing the merged output."""
    with torch.no_grad():
        for _, _, module in _iter_adapted_sites(model):
            w = module.base.weight
            dW = module.scaling * torch.einsum(
                "ri,or->io", module.lora_A.float(), module.lora_B.float())
            w.copy_((w.float() + dW).to(w.dtype))
            module.lora_B.zero_()
    return model
