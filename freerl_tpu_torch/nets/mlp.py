"""MLP trunks and their init schemes (counterpart:
``freerl_tpu/nets/mlp.py``).

``Dense`` keeps the JAX package's init-scheme vocabulary, drawn from an
explicit ``torch.Generator``:

- ``'torch'`` and ``'fanin'``: weight and bias both U(+-1/sqrt(fan_in))
  (the torch default, and DDPG's fan-in init for the other layers);
- ``'final'``: weight and bias both U(+-final_scale), 3e-3 by default
  (DDPG's final layers);
- ``'orthogonal'``: an orthogonal weight scaled by ``gain`` (sqrt(2) by
  default), zero bias (PPO's orthogonal-init trick);
- ``'flax'``: flax ``nn.Dense``'s defaults, a ``lecun_normal`` weight (a
  normal of std ``1/sqrt(fan_in) / 0.8796...`` truncated at +-2 std, so its
  variance is ``1/fan_in``) and a zero bias (the attention critics, which
  the JAX package builds from plain ``nn.Dense``).

``bias=False`` makes a layer with no bias parameter at all (flax's
``use_bias=False``); the ``'flax'`` and ``'orthogonal'`` schemes take it.

:class:`StackedDense` holds ``n`` such layers, one per agent, as one
``(n, out, in)`` weight, and applies them in one batched matmul.

Layers are created, and so initialised, in the JAX modules' order. Weights
are stored torch-style, ``(out, in)``; flax stores ``(in, out)`` (see
``freerl_tpu_torch/convert.py``). An orthogonal flax kernel of shape
``(in, out)`` and torch's ``(out, in)`` weight both satisfy
``W^T W = gain^2 I`` (``W W^T`` when ``out < in``) on the weight torch
holds; the two RNGs never draw the same matrix.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

_ACTS = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "leaky_relu": F.leaky_relu,
    # flax's nn.gelu is the tanh approximation; F.gelu's default is erf
    "gelu": functools.partial(F.gelu, approximate="tanh"),
}

SCHEMES = ("torch", "fanin", "final", "orthogonal", "flax")

# the std of a unit normal truncated at +-2, which lecun_normal divides out
_TRUNC_STD = 0.87962566103423978


def init_scheme(orthogonal: bool) -> str:
    """The scheme of the on-policy nets' ``orthogonal_init`` flag."""
    return "orthogonal" if orthogonal else "torch"


class Dense(nn.Module):
    """Linear layer with an init scheme (see the module docstring)."""

    def __init__(self, in_features: int, features: int,
                 generator: torch.Generator | None = None, device="cuda",
                 scheme: str = "torch", final_scale: float = 3e-3,
                 gain: float = math.sqrt(2.0), bias: bool = True):
        super().__init__()
        if scheme not in SCHEMES:
            raise ValueError(f"unknown init scheme {scheme!r}")
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(features, device=device))
                     if bias else None)
        with torch.no_grad():
            if scheme == "flax":
                std = 1.0 / math.sqrt(in_features) / _TRUNC_STD
                nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                if bias:
                    nn.init.zeros_(self.bias)
                return
            if scheme == "orthogonal":
                nn.init.orthogonal_(self.weight, gain, generator=generator)
                if bias:
                    nn.init.zeros_(self.bias)
                return
            if not bias:
                raise ValueError(f"scheme {scheme!r} always has a bias")
            bound = (final_scale if scheme == "final"
                     else 1.0 / math.sqrt(in_features))
            nn.init.uniform_(self.weight, -bound, bound, generator=generator)
            nn.init.uniform_(self.bias, -bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class StackedDense(nn.Module):
    """``n`` independent ``Dense`` layers, each initialised as ``Dense``
    is, stored as one ``(n, out, in)`` weight and ``(n, out)`` bias. The
    input is ``(n, B, in)``, one batch per layer, or ``(B, in)``, one batch
    that every layer reads; the output is ``(n, B, out)``."""

    def __init__(self, n: int, in_features: int, features: int,
                 generator: torch.Generator | None = None, device="cuda",
                 scheme: str = "torch", gain: float = math.sqrt(2.0)):
        super().__init__()
        layers = [Dense(in_features, features, generator, device, scheme,
                        gain=gain) for _ in range(n)]
        self.weight = nn.Parameter(torch.stack([layer.weight.data
                                                for layer in layers]))
        self.bias = nn.Parameter(torch.stack([layer.bias.data
                                              for layer in layers]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            x = x.expand(self.weight.shape[0], *x.shape)
        return torch.baddbmm(self.bias.unsqueeze(1), x,
                             self.weight.transpose(1, 2))


class Trunk(nn.Module):
    """The hidden layers shared by the nets below: ``Dense`` + activation,
    after ``conv`` (a ``nets/cnn.py`` ``ConvTrunk``, for pixel
    observations) where one is given: the hidden layers then take its
    features."""

    def __init__(self, in_dim: int, hidden: Sequence[int], activation: str,
                 generator: torch.Generator | None, device,
                 scheme: str = "torch", conv: nn.Module | None = None):
        super().__init__()
        self.conv = conv
        dims = [in_dim if conv is None else conv.features, *hidden]
        self.hidden = nn.ModuleList(
            Dense(a, b, generator, device, scheme)
            for a, b in zip(dims[:-1], dims[1:])
        )
        self.act = _ACTS[activation]
        self.trunk_dim = dims[-1]

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv is not None:
            x = self.conv(x)
        for layer in self.hidden:
            x = self.act(layer(x))
        return x


class MLP(Trunk):
    """Trunk + linear head. hidden=(128,) matches the reference default;
    ``scheme`` inits the hidden layers, ``out_scheme`` (default: the same)
    the head, with the orthogonal gain ``out_gain``."""

    def __init__(self, in_dim: int, out_dim: int, hidden: Sequence[int] = (128,),
                 activation: str = "relu",
                 generator: torch.Generator | None = None, device="cuda",
                 scheme: str = "torch", out_scheme: str | None = None,
                 out_gain: float = 1.0, conv: nn.Module | None = None):
        super().__init__(in_dim, hidden, activation, generator, device, scheme,
                         conv)
        self.head = Dense(self.trunk_dim, out_dim, generator, device,
                          out_scheme or scheme, gain=out_gain)

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
