"""Convolutional trunks for pixel observations (counterpart:
``freerl_tpu/nets/cnn.py``).

The trunk takes the flat channel-last observation ``(..., H*W*C)`` the
pixel envs emit and returns ``(..., features)``. Two architectures:

- ``'nature'``: the DQN-Nature stack (32@8x8/4, 64@4x4/2, 64@3x3/1,
  FC-``features``) for 84x84 Atari-scale frames;
- ``'small'``: 16@3x3/1 + 32@3x3/2 + FC for coarse procedural frames
  (``envs/pixel.py`` renders 48x48).

The JAX package convolves NHWC with ``(kh, kw, in, out)`` kernels and
flattens ``(H', W', C')`` before its dense layer. Here the input is viewed
as NHWC, permuted to NCHW for ``F.conv2d`` (padding 0, flax's "VALID"),
and permuted back to NHWC before the flatten, so the dense layer's rows
line up with the JAX package's. Weights are torch-style ``(out, in, kh,
kw)``; ``convert.py`` maps a flax kernel with ``transpose(3, 2, 0, 1)``.

Init, as flax's: each kernel ``he_uniform``, U(+-sqrt(6 / fan_in)) with
``fan_in = kh * kw * in``, and a zero bias (torch's Conv2d default is
another init); the dense layer the torch scheme, U(+-1/sqrt(fan_in)) for
weight and bias, as the JAX trunk's ``torch_default_init``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from freerl_tpu_torch.nets.mlp import Dense

# arch -> (features, kernel, stride) per conv layer
ARCHS = {
    "nature": ((32, 8, 4), (64, 4, 2), (64, 3, 1)),
    "small": ((16, 3, 1), (32, 3, 2)),
}


class ConvTrunk(nn.Module):
    """Flat pixels (..., H*W*C) -> features (..., features)."""

    def __init__(self, obs_shape: Sequence[int], features: int = 512,
                 arch: str = "nature",
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        if arch not in ARCHS:
            raise ValueError(f"unknown conv arch {arch!r}")
        h, w, c = obs_shape
        self.obs_shape = (h, w, c)
        self.strides = []
        self.convs = nn.ParameterList()
        self.biases = nn.ParameterList()
        for f, k, s in ARCHS[arch]:
            bound = math.sqrt(6.0 / (k * k * c))
            weight = torch.empty(f, c, k, k, device=device)
            nn.init.uniform_(weight, -bound, bound, generator=generator)
            self.convs.append(nn.Parameter(weight))
            self.biases.append(nn.Parameter(torch.zeros(f, device=device)))
            self.strides.append(s)
            h, w, c = (h - k) // s + 1, (w - k) // s + 1, f
        self.dense = Dense(h * w * c, features, generator, device)
        self.features = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        x = x.reshape((-1,) + self.obs_shape).permute(0, 3, 1, 2)
        for weight, bias, s in zip(self.convs, self.biases, self.strides):
            x = F.relu(F.conv2d(x, weight, bias, stride=s))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.dense(x))
        return x.reshape(lead + (self.features,))


def conv_trunk(cfg, generator, device):
    """The trunk of a config with ``obs_shape``, ``cnn_features`` and
    ``conv_arch`` (DQN's, PPO's), or None without pixel observations."""
    if cfg.obs_shape is None:
        return None
    return ConvTrunk(tuple(cfg.obs_shape), cfg.cnn_features, cfg.conv_arch,
                     generator, device)
