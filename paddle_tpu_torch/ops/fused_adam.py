"""Adam update math (counterpart of paddle_tpu/ops/fused_adam.py).

`adam_math` is the JAX package's `_adam_math` in the same op order: the
update the JAX default path runs (its Pallas kernel `_adam_kernel` is
opt-in behind FLAGS_use_fused_adam, off by default). The hand-written
single-pass kernel is the next slice's first item (ROADMAP §1); this
module gains it then, with `adam_math` as its plain version.

lr, b1p, b2p and wd are fp32 scalars (0-d tensors or Python floats); p32,
g, m1 and m2 are tensors, g of any float dtype, the rest fp32.
"""
from __future__ import annotations


def adam_math(p32, g, m1, m2, lr, b1p, b2p, wd, *, b1, b2, eps, decoupled):
    """Returns (new p32, new m1, new m2), all fp32."""
    g = g.float()
    if not decoupled:
        g = g + wd * p32
    m1n = b1 * m1 + (1.0 - b1) * g
    m2n = b2 * m2 + (1.0 - b2) * g * g
    update = (m1n / (1.0 - b1p)) / (
        (m2n / (1.0 - b2p)).sqrt() + eps)
    if decoupled:
        update = update + wd * p32
    return p32 - lr * update, m1n, m2n
