"""paddle.save / paddle.load (counterpart of paddle_tpu/framework_io.py).

The JAX package's file format, so `.pdparams` and `.pdopt` files cross
both ways: a pickle (protocol 4) of the object with every tensor turned
into a numpy array, and a bfloat16 tensor (numpy has no bf16) into
`{"__bf16__": True, "data": <its fp32 values>}`. `load` turns every
array back into a tensor on `device` (the first GPU by default; raises
without one unless `device="cpu"`), a tagged entry into bf16. The JAX
checkpoint managers pickle their state's arrays as they are (JAX
arrays, and numpy arrays of ml_dtypes' bfloat16 in a host snapshot), so
`load` takes any array a pickle holds: whatever converts with
`np.asarray`, bfloat16 bits reinterpreted as torch's bf16. Unpickle
only files this program or the JAX package wrote: unpickling runs code.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .core.device import resolve_device

_BF16_TAG = "__bf16__"


def _pack(obj):
    if torch.is_tensor(obj):
        t = obj.detach()
        if t.dtype == torch.bfloat16:
            # to the host first: half the bytes of an fp32 copy
            return {_BF16_TAG: True, "data": t.cpu().float().numpy()}
        return t.cpu().numpy()
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _is_array(obj) -> bool:
    """A numpy array, or another library's array (one `np.asarray`
    converts, not a numpy scalar)."""
    return isinstance(obj, np.ndarray) or (
        hasattr(obj, "__array__") and hasattr(obj, "shape")
        and hasattr(obj, "dtype") and not isinstance(obj, np.generic)
        and not torch.is_tensor(obj))


def _array_to_tensor(obj, device):
    """An owned tensor on `device` from an array; bfloat16 (ml_dtypes,
    which numpy cannot hand to torch) by its bits."""
    a = np.asarray(obj)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _unpack(obj, device):
    if isinstance(obj, dict):
        if obj.get(_BF16_TAG):
            return torch.from_numpy(np.asarray(obj["data"])).to(
                device=device, dtype=torch.bfloat16)
        return {k: _unpack(v, device) for k, v in obj.items()}
    if _is_array(obj):
        return _array_to_tensor(obj, device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, device) for v in obj)
    return obj


def dump(obj, f, protocol=4):
    """Write `obj` in this format into the binary file object `f`."""
    pickle.dump(_pack(obj), f, protocol=protocol)


def save(obj, path, protocol=4, **configs):
    """Write `obj` (a state dict, or any nest of dicts, lists, tuples,
    tensors and Python values) to `path`, making its directory."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        dump(obj, f, protocol=protocol)


def load(path, device=None, **configs):
    """Read what `save` (here or in the JAX package) wrote; every array
    comes back as a tensor on `device`."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        return _unpack(pickle.load(f), device)
