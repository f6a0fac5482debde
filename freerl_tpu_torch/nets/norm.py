"""flax's ``nn.LayerNorm``, written out (the JAX package's MAPPO trunks,
GRU trunks and MAT use it).

torch's ``nn.LayerNorm`` and ``F.layer_norm`` differ from it twice: their
epsilon is 1e-5 where flax's is 1e-6, and they compute the variance as
``E[(x - E[x])^2]`` where flax (``use_fast_variance=True``) computes
``E[x^2] - E[x]^2``, clamped at 0. So the port computes it as flax does,
in flax's order: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, with
``scale`` starting at ones and ``bias`` at zeros.

``n`` stacks ``n`` independent norms (one per agent, beside
``StackedDense``): their ``scale`` and ``bias`` are ``(n, features)`` and
apply to an ``(n, B, features)`` input, or broadcast a ``(B, features)``
input to it.
"""
from __future__ import annotations

import torch
from torch import nn

# flax's LayerNorm default (torch's is 1e-5)
_EPS = 1e-6


class LayerNorm(nn.Module):
    def __init__(self, features: int, device="cuda", n: int | None = None):
        super().__init__()
        shape = (features,) if n is None else (n, features)
        self.scale = nn.Parameter(torch.ones(shape, device=device))
        self.bias = nn.Parameter(torch.zeros(shape, device=device))
        self.stacked = n is not None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = torch.mean(x, dim=-1, keepdim=True)
        mean2 = torch.mean(torch.square(x), dim=-1, keepdim=True)
        var = torch.clamp(mean2 - torch.square(mean), min=0.0)
        scale, bias = self.scale, self.bias
        if self.stacked:
            scale, bias = scale.unsqueeze(-2), bias.unsqueeze(-2)
        return (x - mean) * (torch.rsqrt(var + _EPS) * scale) + bias
