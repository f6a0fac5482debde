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

Determinism: the same seed gives the same run, as XLA gives it on the
TPU. cuDNN's default algorithms for a convolution's backward are not
deterministic on the card (another gradient on every run), so every
convolution of the trunk, forward and backward, runs with cuDNN's
deterministic algorithms and no autotuning (:func:`conv2d`). The two flags
that pick them are process-global and read when cuDNN is called, and the
backward runs in the caller's ``loss.backward()``, outside the trunk: so
the backward sets them itself, and sets them back as it found them.
Nothing else of the process's cuDNN settings is touched (whether cuDNN is
on, TF32). In a single-threaded process a convolution outside the trunk
keeps the process's algorithms; the two flags are process-global, so a
CUDA convolution that another thread issues while a trunk convolution
runs (forward, or backward on autograd's device thread) runs under them
too. Nothing falls back to the default algorithms: where cuDNN
has no deterministic one for a shape, its error reaches the caller. On
the CPU the flags do nothing: :func:`conv2d` computes what ``F.conv2d``
computes, bit for bit. The cost on the card is cuDNN's deterministic
weight-gradient kernel (PERF.md §5).
"""
from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms, without autotuning, inside the
    block; ``deterministic`` and ``benchmark`` read as before after it."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` (padding 0, no dilation, one group) with its forward
    and its backward under :func:`_deterministic_cudnn`."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride):
        ctx.save_for_backward(x, weight)
        ctx.stride = stride
        with _deterministic_cudnn():
            return F.conv2d(x, weight, bias, stride=stride)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        s = ctx.stride
        with _deterministic_cudnn():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]], [s, s], [0, 0], [1, 1],
                False, [0, 0], 1, list(ctx.needs_input_grad[:3]))
        return gx, gw, gb, None


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           stride: int) -> torch.Tensor:
    """The trunk's convolution: ``F.conv2d(x, weight, bias, stride)`` on
    cuDNN's deterministic algorithms, forward and backward."""
    return _Conv2d.apply(x, weight, bias, stride)


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
            x = F.relu(conv2d(x, weight, bias, s))
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
