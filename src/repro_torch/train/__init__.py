"""Training substrate: optimizer, step, checkpointing, fault-tolerant loop
(the port's counterpart of ``repro.train``)."""

from .optimizer import AdamConfig, AdamState, adam_init, adam_step, \
    global_norm, lr_schedule
from .data import DataConfig, TokenStream
from .train_step import TrainConfig, init_train_state, make_train_step
from .checkpoint import Checkpointer
from .loop import FaultTolerantLoop, LoopConfig

__all__ = [
    "AdamConfig", "AdamState", "adam_init", "adam_step", "global_norm",
    "lr_schedule", "DataConfig", "TokenStream", "TrainConfig",
    "init_train_state", "make_train_step", "Checkpointer",
    "FaultTolerantLoop", "LoopConfig",
]
