from .api import (ScanTrainStep, ShardedTrainStep,  # noqa: F401
                  apply_selective_remat, make_compute_loss, parallelize,
                  stack_batches)
