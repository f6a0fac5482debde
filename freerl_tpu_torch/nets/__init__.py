from freerl_tpu_torch.nets.mlp import MLP, CategoricalQNet, Dense, DuelingQNet
from freerl_tpu_torch.nets.noisy import (NoisyCategoricalQNet, NoisyDense,
                                         NoisyDuelingQNet, NoisyMLP)

__all__ = [
    "MLP",
    "Dense",
    "DuelingQNet",
    "CategoricalQNet",
    "NoisyDense",
    "NoisyMLP",
    "NoisyDuelingQNet",
    "NoisyCategoricalQNet",
]
