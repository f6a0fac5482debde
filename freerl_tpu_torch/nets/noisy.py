"""Factorized-Gaussian noisy linear layers (NoisyNet exploration;
counterpart: ``freerl_tpu/nets/noisy.py``).

``w_mu`` and ``b_mu`` start U(+-1/sqrt(fan_in)), ``w_sigma`` at
sigma_init/sqrt(fan_in) and ``b_sigma`` at sigma_init/sqrt(features) (the
reference divides the bias sigma by the output width). The noise is
factorized, f(x) = sign(x)*sqrt(|x|), and is always an argument:
``forward(x, (eps_in, eps_out))`` applies it, ``forward(x)`` is the
noiseless (mu-only) layer, and ``draw_noise(generator, rows)`` makes a
draw from an explicit ``torch.Generator``.

A draw is shared by the whole batch (``eps_in`` (in,), ``eps_out`` (out,))
or made per row (``(B, in)``, ``(B, out)``): exploration gives every env
row its own noise. The per-row form never builds a (B, out, in) weight; it
uses the factorized identity
``y = x w_mu^T + b_mu + eps_out * ((x * eps_in) w_sigma^T + b_sigma)``.
Weights are stored torch-style, ``(out, in)``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from freerl_tpu_torch.nets.mlp import Trunk


def factorized(eps: torch.Tensor) -> torch.Tensor:
    """f(x) = sign(x) * sqrt(|x|)."""
    return torch.sign(eps) * torch.sqrt(torch.abs(eps))


class NoisyDense(nn.Module):
    def __init__(self, in_features: int, features: int,
                 sigma_init: float = 0.05,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        self.in_features, self.features = in_features, features
        bound = 1.0 / math.sqrt(in_features)

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device))

        self.w_mu = param(features, in_features)
        self.w_sigma = param(features, in_features)
        self.b_mu = param(features)
        self.b_sigma = param(features)
        with torch.no_grad():
            nn.init.uniform_(self.w_mu, -bound, bound, generator=generator)
            nn.init.uniform_(self.b_mu, -bound, bound, generator=generator)
            self.w_sigma.fill_(sigma_init / math.sqrt(in_features))
            self.b_sigma.fill_(sigma_init / math.sqrt(features))

    def draw_noise(self, generator: torch.Generator, rows: int | None = None):
        """One ``(eps_in, eps_out)`` draw; per row when ``rows`` is given."""
        lead = () if rows is None else (rows,)
        dev = self.w_mu.device
        eps_in = torch.randn(lead + (self.in_features,), generator=generator,
                             device=dev)
        eps_out = torch.randn(lead + (self.features,), generator=generator,
                              device=dev)
        return factorized(eps_in), factorized(eps_out)

    def forward(self, x: torch.Tensor, noise=None) -> torch.Tensor:
        if noise is None:
            return F.linear(x, self.w_mu, self.b_mu)
        eps_in, eps_out = noise
        if eps_in.dim() == 1:
            # one draw for the batch: the JAX layer's perturbed weight
            w = self.w_mu + self.w_sigma * (eps_out[:, None] * eps_in[None, :])
            return F.linear(x, w, self.b_mu + self.b_sigma * eps_out)
        return (F.linear(x, self.w_mu, self.b_mu)
                + eps_out * (F.linear(x * eps_in, self.w_sigma) + self.b_sigma))


class NoisyHeads(Trunk):
    """A plain trunk with heads that may be noisy. ``heads`` names the
    noisy heads in creation order; a forward's ``noise`` holds one
    ``(eps_in, eps_out)`` per noisy head in that order, or is None for the
    noiseless forward."""

    heads: tuple[str, ...] = ()

    def draw_noise(self, generator: torch.Generator, rows: int | None = None):
        return [getattr(self, h).draw_noise(generator, rows)
                for h in self.heads]

    def head_out(self, name: str, x: torch.Tensor, noise) -> torch.Tensor:
        layer = getattr(self, name)
        if noise is None or name not in self.heads:
            return layer(x)
        return layer(x, noise[self.heads.index(name)])


class NoisyMLP(NoisyHeads):
    """Ordinary hidden layers + a NoisyDense output layer."""

    heads = ("head",)

    def __init__(self, in_dim: int, out_dim: int, hidden: Sequence[int] = (128,),
                 sigma_init: float = 0.05,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__(in_dim, hidden, "relu", generator, device)
        self.head = NoisyDense(self.trunk_dim, out_dim, sigma_init, generator,
                               device)

    def forward(self, x: torch.Tensor, noise=None) -> torch.Tensor:
        return self.head_out("head", self.trunk(x), noise)


class NoisyDuelingQNet(NoisyHeads):
    """Ordinary trunk; noisy V and A heads, V created first."""

    heads = ("v_head", "head")

    def __init__(self, in_dim: int, out_dim: int, hidden: Sequence[int] = (128,),
                 sigma_init: float = 0.05,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__(in_dim, hidden, "relu", generator, device)
        self.v_head = NoisyDense(self.trunk_dim, 1, sigma_init, generator,
                                 device)
        self.head = NoisyDense(self.trunk_dim, out_dim, sigma_init, generator,
                               device)

    def forward(self, x: torch.Tensor, noise=None) -> torch.Tensor:
        x = self.trunk(x)
        a = self.head_out("head", x, noise)
        return (self.head_out("v_head", x, noise) + a
                - torch.mean(a, dim=-1, keepdim=True))


class NoisyCategoricalQNet(NoisyHeads):
    """Ordinary trunk; noisy atom-logit head, (..., action_dim, n_atoms)."""

    heads = ("head",)

    def __init__(self, in_dim: int, action_dim: int, n_atoms: int = 51,
                 hidden: Sequence[int] = (128,), sigma_init: float = 0.05,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__(in_dim, hidden, "relu", generator, device)
        self.action_dim, self.n_atoms = action_dim, n_atoms
        self.head = NoisyDense(self.trunk_dim, action_dim * n_atoms,
                               sigma_init, generator, device)

    def forward(self, x: torch.Tensor, noise=None) -> torch.Tensor:
        logits = self.head_out("head", self.trunk(x), noise)
        return logits.reshape(x.shape[:-1] + (self.action_dim, self.n_atoms))
