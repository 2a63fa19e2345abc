"""optim — optimizers + lr schedules (reference: python/oneflow/optim)."""

from of_spmm.optim import lr_scheduler
from of_spmm.optim.indexed_slices import (
    IndexedSlices,
    reduce_ids,
    sparse_adam_update,
    sparse_sgd_update,
    sparse_value_and_grad,
)
from of_spmm.optim.optimizers import (
    Optimizer,
    adadelta,
    adagrad,
    adam,
    adamw,
    clip_grad_norm,
    ftrl,
    lamb,
    rmsprop,
    sgd,
)

__all__ = [
    "Optimizer",
    "sgd",
    "adam",
    "adamw",
    "lamb",
    "ftrl",
    "rmsprop",
    "adagrad",
    "adadelta",
    "clip_grad_norm",
    "lr_scheduler",
    "IndexedSlices",
    "reduce_ids",
    "sparse_adam_update",
    "sparse_sgd_update",
    "sparse_value_and_grad",
]
