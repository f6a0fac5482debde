"""Shared algorithmic building blocks (counterpart:
``freerl_tpu/algos/common.py``). The rest of that module (GAE, surrogate
losses) comes with the slices that use it."""
from __future__ import annotations

from typing import Iterable

import torch


@torch.no_grad()
def polyak(target_params: Iterable[torch.Tensor],
           online_params: Iterable[torch.Tensor], tau: float) -> None:
    """theta_target <- theta_target*(1-tau) + theta*tau, in place, with the
    JAX formula's rounding (no fused multiply-add)."""
    for t, o in zip(target_params, online_params):
        t.mul_(1.0 - tau).add_(o * tau)


def td_target(reward: torch.Tensor, gamma, next_value: torch.Tensor,
              done: torch.Tensor) -> torch.Tensor:
    """r + gamma * V' * (1 - done); gamma may be per-sample (n-step)."""
    return reward + gamma * next_value * (1.0 - done.to(torch.float32))


def clip_grads_by_norm(grads: list[torch.Tensor],
                       max_norm: float) -> list[torch.Tensor]:
    """Scale a group of gradients by ``min(1, max_norm / (norm + 1e-6))``,
    where ``norm`` is the group's global L2 norm (the JAX formula, not
    ``torch.nn.utils.clip_grad_norm_``'s)."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [g * scale for g in grads]


def c51_project(next_probs: torch.Tensor, tz: torch.Tensor,
                atoms: torch.Tensor) -> torch.Tensor:
    """Project the shifted atom distribution back onto the fixed support.

    next_probs: (B, N) probabilities of the target distribution.
    tz:         (B, N) shifted atom positions r + gamma*z*(1-d), pre-clip.
    atoms:      (N,) fixed support.
    Returns (B, N) projected probabilities.

    The JAX package scatters ``p*(high-b)`` to ``floor(b)`` and
    ``p*(b-low)`` to ``ceil(b)`` (all of ``p`` to ``b`` when ``b`` is an
    integer). This is the same sum written densely,
    ``proj[b, j] = sum_i p[b, i] * relu(1 - |b_i - j|)``, so no two adds
    race: a CUDA scatter-add accumulates with float atomics in no fixed
    order, and its result would change from run to run.
    """
    v_min, v_max = atoms[0], atoms[-1]        # device scalars: no host sync
    n = atoms.shape[0]
    dz = (v_max - v_min) / (n - 1)
    b = (torch.clamp(tz, v_min, v_max) - v_min) / dz                 # (B, N)
    j = torch.arange(n, dtype=b.dtype, device=b.device)
    weight = torch.relu(1.0 - torch.abs(b[:, :, None] - j))          # (B, N, N)
    return torch.sum(next_probs[:, :, None] * weight, dim=1)
