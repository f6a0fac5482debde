"""MLP trunks with the torch init scheme (counterpart:
``freerl_tpu/nets/mlp.py``).

``Dense`` keeps the JAX package's ``'torch'`` scheme: weight and bias both
U(+-1/sqrt(fan_in)), drawn from an explicit ``torch.Generator``. The
orthogonal and final-uniform schemes come with the slices that use them.
Layers are created, and so initialised, in the JAX modules' order.
Weights are stored torch-style, ``(out, in)``; flax stores ``(in, out)``
(see ``freerl_tpu_torch/convert.py``).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

_ACTS = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "leaky_relu": F.leaky_relu,
    "gelu": F.gelu,
}


class Dense(nn.Module):
    """Linear layer with the torch default init, U(+-1/sqrt(fan_in)) for
    weight and bias."""

    def __init__(self, in_features: int, features: int,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        with torch.no_grad():
            nn.init.uniform_(self.weight, -bound, bound, generator=generator)
            nn.init.uniform_(self.bias, -bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Trunk(nn.Module):
    """The hidden layers shared by the nets below: ``Dense`` + activation."""

    def __init__(self, in_dim: int, hidden: Sequence[int], activation: str,
                 generator: torch.Generator | None, device):
        super().__init__()
        dims = [in_dim, *hidden]
        self.hidden = nn.ModuleList(
            Dense(a, b, generator, device) for a, b in zip(dims[:-1], dims[1:])
        )
        self.act = _ACTS[activation]
        self.trunk_dim = dims[-1]

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.hidden:
            x = self.act(layer(x))
        return x


class MLP(Trunk):
    """Trunk + linear head. hidden=(128,) matches the reference default."""

    def __init__(self, in_dim: int, out_dim: int, hidden: Sequence[int] = (128,),
                 activation: str = "relu",
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__(in_dim, hidden, activation, generator, device)
        self.head = Dense(self.trunk_dim, out_dim, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(x))


class DuelingQNet(Trunk):
    """Dueling head: Q = V + A - mean_a(A). V is created before A."""

    def __init__(self, in_dim: int, action_dim: int,
                 hidden: Sequence[int] = (128,), activation: str = "relu",
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__(in_dim, hidden, activation, generator, device)
        self.v_head = Dense(self.trunk_dim, 1, generator, device)
        self.head = Dense(self.trunk_dim, action_dim, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.trunk(x)
        a = self.head(x)
        return self.v_head(x) + a - torch.mean(a, dim=-1, keepdim=True)


class CategoricalQNet(Trunk):
    """C51 head: per-action atom logits, shape (..., action_dim, n_atoms)."""

    def __init__(self, in_dim: int, action_dim: int, n_atoms: int = 51,
                 hidden: Sequence[int] = (128,), activation: str = "relu",
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__(in_dim, hidden, activation, generator, device)
        self.action_dim, self.n_atoms = action_dim, n_atoms
        self.head = Dense(self.trunk_dim, action_dim * n_atoms, generator,
                          device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.head(self.trunk(x))
        return logits.reshape(x.shape[:-1] + (self.action_dim, self.n_atoms))
