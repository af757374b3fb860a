"""paddle.callbacks (counterpart of paddle_tpu/callbacks.py): the hapi
callbacks re-exported at the package root."""
from .hapi.callbacks import (Callback, EarlyStopping, LRScheduler,  # noqa
                             ModelCheckpoint, ProgBarLogger)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler"]
