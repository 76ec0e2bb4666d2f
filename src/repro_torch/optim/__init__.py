from repro_torch.optim.optimizers import Optimizer, TrainState, adamw, sgd
from repro_torch.optim.schedules import (
    constant, cosine_decay, rsqrt, warmup_linear, wsd,
)

__all__ = ["Optimizer", "sgd", "adamw", "TrainState", "constant",
           "cosine_decay", "wsd", "rsqrt", "warmup_linear"]
