"""Recurrent (GRU) policy and value trunks for rMAPPO (counterpart:
``freerl_tpu/nets/rnn.py``).

:class:`GRUCell` is flax's ``nn.GRUCell`` with flax's parameters, not
torch's ``nn.GRUCell``: the input denses ``ir``, ``iz`` and ``in`` carry
the biases, the recurrent ``hr`` and ``hz`` have none and ``hn`` has one.
torch's cell also has recurrent biases for the r and z gates, which Adam
would train. The input kernels start at ``lecun_normal`` (the ``'flax'``
scheme) and the recurrent ones are orthogonal (gain 1); every bias starts
at zero. ``h' = (1 - z) * n + z * h``.

The trunks take ``reset`` (bool, one per row: "an episode ended in the
previous step") and zero the incoming hidden state there, ``h * (1 -
reset)``, before the cell.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from freerl_tpu_torch.nets.mlp import Dense, init_scheme
from freerl_tpu_torch.nets.norm import LayerNorm


class GRUCell(nn.Module):
    """One step of flax's GRU: ``(h, x) -> h'``. Its denses sit in
    ``dense`` under flax's names."""

    def __init__(self, in_features: int, features: int,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()

        def dense(kind: str):
            if kind[0] == "i":
                return Dense(in_features, features, generator, device, "flax")
            return Dense(features, features, generator, device, "orthogonal",
                         gain=1.0, bias=kind == "hn")

        # flax creates them in the order the cell calls them
        self.dense = nn.ModuleDict(
            (k, dense(k)) for k in ("ir", "hr", "iz", "hz", "in", "hn"))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        d = self.dense
        r = torch.sigmoid(d["ir"](x) + d["hr"](h))
        z = torch.sigmoid(d["iz"](x) + d["hz"](h))
        n = torch.tanh(d["in"](x) + r * d["hn"](h))
        return (1.0 - z) * n + z * h


class RecurrentTrunk(nn.Module):
    """MLP encoder (``Dense``, LayerNorm under ``layer_norm``, relu) ->
    reset -> GRU cell -> LayerNorm under ``layer_norm``. Returns
    ``(features, new_hidden)``; the hidden state is the cell's output
    before the last norm."""

    def __init__(self, in_dim: int, hidden: Sequence[int] = (128,),
                 rnn_hidden: int = 128, orthogonal: bool = False,
                 layer_norm: bool = False,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        dims = [in_dim, *hidden]
        self.layers = nn.ModuleList(
            Dense(a, b, generator, device, init_scheme(orthogonal))
            for a, b in zip(dims[:-1], dims[1:]))
        self.norms = nn.ModuleList(
            LayerNorm(h, device) for h in (hidden if layer_norm else ()))
        self.gru = GRUCell(dims[-1], rnn_hidden, generator, device)
        self.out_norm = LayerNorm(rnn_hidden, device) if layer_norm else None

    def forward(self, x: torch.Tensor, h: torch.Tensor, reset: torch.Tensor):
        for j, layer in enumerate(self.layers):
            x = layer(x)
            if self.norms:
                x = self.norms[j](x)
            x = F.relu(x)
        h = h * (1.0 - reset.to(x.dtype)[..., None])
        h = self.gru(h, x)
        out = h if self.out_norm is None else self.out_norm(h)
        return out, h


class RecurrentActor(nn.Module):
    """One-step recurrent actor: ``(obs, hidden, reset) -> (dist params,
    new hidden)``; logits, or ``(tanh mean, log_std)`` with a
    state-independent ``log_std`` starting at 0."""

    def __init__(self, in_dim: int, action_dim: int, is_continue: bool,
                 hidden: Sequence[int] = (128,), rnn_hidden: int = 128,
                 orthogonal: bool = False, layer_norm: bool = False,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        self.trunk = RecurrentTrunk(in_dim, hidden, rnn_hidden, orthogonal,
                                    layer_norm, generator, device)
        self.head = Dense(rnn_hidden, action_dim, generator, device,
                          init_scheme(orthogonal), gain=0.01)
        self.log_std = (nn.Parameter(torch.zeros(action_dim, device=device))
                        if is_continue else None)

    def forward(self, x, h, reset):
        x, h = self.trunk(x, h, reset)
        out = self.head(x)
        if self.log_std is None:
            return out, h
        mean = torch.tanh(out)
        return (mean, self.log_std.expand_as(mean)), h


class RecurrentVCritic(nn.Module):
    """One-step recurrent V(s): ``(obs, hidden, reset) -> (v, hidden)``."""

    def __init__(self, in_dim: int, hidden: Sequence[int] = (128,),
                 rnn_hidden: int = 128, orthogonal: bool = False,
                 layer_norm: bool = False,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        self.trunk = RecurrentTrunk(in_dim, hidden, rnn_hidden, orthogonal,
                                    layer_norm, generator, device)
        self.head = Dense(rnn_hidden, 1, generator, device,
                          init_scheme(orthogonal), gain=1.0)

    def forward(self, x, h, reset):
        x, h = self.trunk(x, h, reset)
        return self.head(x).squeeze(-1), h
