from freerl_tpu_torch.nets.cnn import ConvTrunk
from freerl_tpu_torch.nets.mlp import (MLP, CategoricalQNet, Dense,
                                       DuelingQNet, StackedDense)
from freerl_tpu_torch.nets.noisy import (NoisyCategoricalQNet, NoisyDense,
                                         NoisyDuelingQNet, NoisyMLP)
from freerl_tpu_torch.nets.norm import LayerNorm
from freerl_tpu_torch.nets.rnn import (GRUCell, RecurrentActor,
                                       RecurrentTrunk, RecurrentVCritic)

__all__ = [
    "ConvTrunk",
    "MLP",
    "Dense",
    "DuelingQNet",
    "CategoricalQNet",
    "NoisyDense",
    "NoisyMLP",
    "NoisyDuelingQNet",
    "NoisyCategoricalQNet",
    "StackedDense",
    "LayerNorm",
    "GRUCell",
    "RecurrentTrunk",
    "RecurrentActor",
    "RecurrentVCritic",
]
