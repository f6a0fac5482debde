"""Shared algorithmic building blocks (counterpart:
``freerl_tpu/algos/common.py``)."""
from __future__ import annotations

from typing import Iterable, Sequence

import torch

from freerl_tpu_torch.distributed.dp import pmean


@torch.no_grad()
def polyak(target_params: Iterable[torch.Tensor],
           online_params: Iterable[torch.Tensor], tau: float) -> None:
    """theta_target <- theta_target*(1-tau) + theta*tau, in place, with the
    JAX formula's rounding (no fused multiply-add). The multi-tensor
    (foreach) ops launch a few kernels for the whole group instead of
    three per tensor."""
    targets = list(target_params)
    torch._foreach_mul_(targets, 1.0 - tau)
    torch._foreach_add_(targets, torch._foreach_mul(list(online_params), tau))


def net_params(nets: Iterable[torch.nn.Module]) -> list[torch.Tensor]:
    """Every parameter of several nets, in order: one group for one
    ``polyak`` call (the multi-agent family's per-agent nets)."""
    return [p for net in nets for p in net.parameters()]


def td_target(reward: torch.Tensor, gamma, next_value: torch.Tensor,
              done: torch.Tensor) -> torch.Tensor:
    """r + gamma * V' * (1 - done); gamma may be per-sample (n-step)."""
    return reward + gamma * next_value * (1.0 - done.to(torch.float32))


def huber(x: torch.Tensor, delta: float = 10.0) -> torch.Tensor:
    """The reference's huber loss, delta 10 by default."""
    ax = torch.abs(x)
    return torch.where(ax <= delta, 0.5 * x ** 2, delta * (ax - 0.5 * delta))


def clipped_surrogate(ratio: torch.Tensor, adv: torch.Tensor,
                      clip_eps: float) -> torch.Tensor:
    """PPO's clipped surrogate, as a loss: ``-min(r A, clip(r) A)``."""
    return -torch.minimum(
        ratio * adv, torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv)


def value_clip_loss(values: torch.Tensor, old_values: torch.Tensor,
                    returns: torch.Tensor, clip_eps: float,
                    use_huber: bool = False,
                    huber_delta: float = 10.0) -> torch.Tensor:
    """The ValueClip loss: the larger of the clipped and the unclipped
    value errors, elementwise (half squares, or huber)."""
    clipped = old_values + torch.clamp(values - old_values, -clip_eps,
                                       clip_eps)
    if use_huber:
        e1 = huber(returns - values, huber_delta)
        e2 = huber(returns - clipped, huber_delta)
    else:
        e1 = 0.5 * (returns - values) ** 2
        e2 = 0.5 * (returns - clipped) ** 2
    return torch.maximum(e1, e2)


def gae(rewards: torch.Tensor, values: torch.Tensor,
        next_values: torch.Tensor, dones: torch.Tensor,
        episode_dones: torch.Tensor, gamma: float, lam: float):
    """Generalized advantage estimation over a (T, ...) time-major rollout.
    Returns ``(advantages, advantages + values)``.

    ``dones`` masks bootstrapping (terminated only); ``episode_dones`` cuts
    the advantage recursion at episode ends (terminated OR truncated). The
    recursion is a reverse Python loop over T on device tensors: no host
    sync.
    """
    deltas = rewards + gamma * next_values * (
        1.0 - dones.to(torch.float32)) - values
    cut = 1.0 - episode_dones.to(torch.float32)
    adv = torch.zeros_like(deltas[0])
    advs = []
    for t in range(deltas.shape[0] - 1, -1, -1):
        adv = deltas[t] + gamma * lam * cut[t] * adv
        advs.append(adv)
    advs = torch.stack(advs[::-1])
    return advs, advs + values


def adv_normalize(adv: torch.Tensor, eps: float,
                  axis_name: str | None = None) -> torch.Tensor:
    """``(adv - mean) / (std + eps)`` with the population std. Under
    ``axis_name`` the moments are the GLOBAL batch's, averaged over the
    ranks and the std taken as ``sqrt(max(E[x^2] - E[x]^2, 0))``, as the
    JAX package's sharded branch computes it (its rounding differs from
    the local ``std``)."""
    if axis_name is None:
        return (adv - torch.mean(adv)) / (torch.std(adv, correction=0) + eps)
    m, sq = pmean(torch.stack([torch.mean(adv), torch.mean(torch.square(adv))]),
                  axis_name)
    std = torch.sqrt(torch.clamp(sq - torch.square(m), min=0.0))
    return (adv - m) / (std + eps)


def clip_grads_by_norm(grads: list[torch.Tensor],
                       max_norm: float) -> list[torch.Tensor]:
    """Scale a group of gradients by ``min(1, max_norm / (norm + 1e-6))``,
    where ``norm`` is the group's global L2 norm (the JAX formula, not
    ``torch.nn.utils.clip_grad_norm_``'s)."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [g * scale for g in grads]


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float) -> list[torch.Tensor]:
    """``optax.clip_by_global_norm``: a group of gradients is kept as it is
    when its global L2 norm is below ``max_norm``, and is otherwise
    ``(g / norm) * max_norm``, with no epsilon. The choice is a
    ``torch.where`` on the device, so it costs no host sync. The group is
    clipped as one flat tensor (eight kernels, however many tensors) and
    handed back as views of it."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    norm = torch.sqrt(torch.sum(torch.square(flat)))
    flat = torch.where(norm < max_norm, flat, (flat / norm) * max_norm)
    parts = torch.split(flat, [g.numel() for g in grads])
    return [part.view(g.shape) for part, g in zip(parts, grads)]


def optimizer_step(opt: torch.optim.Optimizer, params: list[torch.Tensor],
                   loss: torch.Tensor, max_norm: float | None = None,
                   axis_name: str | None = None) -> None:
    """One step of ``opt`` on ``params`` down the gradient of ``loss``,
    averaged over the ranks of ``axis_name`` when it is given, then
    clipped by :func:`clip_by_global_norm` when ``max_norm`` is given.
    Only ``params`` get gradients: a loss that runs through another net
    (the critic under the actor loss) leaves that net's ``.grad``
    alone."""
    grads = pmean(list(torch.autograd.grad(loss, params)), axis_name)
    if max_norm is not None:
        grads = clip_by_global_norm(grads, max_norm)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


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


def explained_variance(returns: torch.Tensor,
                       values: torch.Tensor) -> torch.Tensor:
    """``1 - Var(returns - values) / max(Var(returns), 1e-8)``, with
    population variances (``jnp.var``'s)."""
    var_r = torch.var(returns, correction=0)
    return 1.0 - torch.var(returns - values, correction=0) / torch.clamp(
        var_r, min=1e-8)


def global_grad_norm(grads) -> torch.Tensor:
    """The global L2 norm of ``grads``: a sequence or dict of tensors
    (nested ones too, as a pytree's leaves), or a module, whose
    parameters' ``.grad`` are taken where they are set."""
    if isinstance(grads, torch.nn.Module):
        grads = [p.grad for p in grads.parameters() if p.grad is not None]

    def leaves(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, dict):
            x = x.values()
        return [t for v in x for t in leaves(v)]

    sq = [torch.sum(torch.square(g)) for g in leaves(grads)]
    return torch.sqrt(torch.stack(sq).sum() if sq else torch.zeros(()))
