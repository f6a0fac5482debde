"""N-step return folding at sample time (counterpart:
``freerl_tpu/buffers/nstep.py``).

The ring stores raw transitions. With a vector of E envs written per step,
the time-successor of slot ``i`` (same env) is slot ``i + E`` (mod
capacity), so an n-step target is a strided gather of n slots plus a
masked fold, cut at the first ``episode_done``:

    R = sum_{k < m} gamma^k r_k,   m = min(n, first episode end + 1)
    next_obs, done = those of step m,   effective discount = gamma^m

It works for the uniform and the PER buffer alike (fold from the
prioritized start slot). The buffers' ``size``, ``pos`` and ``capacity``
are host ints, so the range of valid starts is a host int too and costs no
device sync.
"""
from __future__ import annotations

import torch

from freerl_tpu_torch.core.types import Transition


def nstep_count(size: int, capacity: int, stride: int, n: int) -> int:
    """How many start slots have all n-1 same-env successors written.

    When the ring has not wrapped, valid starts are [0, size - (n-1)*stride).
    When full, the oldest slot sits at ``pos``; valid offsets from it are
    [0, capacity - (n-1)*stride). At least 1.
    """
    span = (n - 1) * stride
    return max((capacity if size >= capacity else size) - span, 1)


def nstep_sample_range(size: int, capacity: int, pos: int,
                       d: torch.Tensor) -> torch.Tensor:
    """Start indices from the offsets ``d`` (B,), each drawn uniformly from
    ``[0, nstep_count(size, capacity, stride, n))``: offsets from the oldest
    slot once the ring is full, slots from 0 before."""
    return (pos + d) % capacity if size >= capacity else d


def nstep_fold(data: Transition, idx: torch.Tensor, stride: int, n: int,
               gamma: float):
    """Gather n successor slots per start index and fold the n-step target.

    Returns a Transition whose ``reward`` is the folded n-step return and
    whose ``next_obs``/``done``/``episode_done`` are taken at the fold
    horizon, and the per-sample effective discount ``gamma^m`` for the TD
    backup.
    """
    idx = idx.to(torch.int64)
    ks = torch.arange(n, device=idx.device)
    cap = data.obs.shape[0]
    gidx = (idx[:, None] + ks[None, :] * stride) % cap             # (B, n)
    rewards = data.reward[gidx]
    ep_dones = data.episode_done[gidx].to(torch.float32)

    # alive[k] = 1 if step k is within this episode (no episode_done before k)
    prev_done = torch.cat(
        [torch.zeros_like(ep_dones[:, :1]), ep_dones[:, :-1]], dim=1)
    alive = torch.cumprod(1.0 - prev_done, dim=1)
    discounts = torch.pow(gamma, ks.to(torch.float32))[None, :]
    ret = torch.sum(rewards * alive * discounts, dim=1)

    # horizon index m-1 = last alive step
    m = torch.sum(alive, dim=1).to(torch.int64)                    # in [1, n]
    last = torch.clamp(m - 1, 0, n - 1)
    last_gidx = torch.gather(gidx, 1, last[:, None])[:, 0]
    eff_gamma = torch.pow(gamma, m.to(torch.float32))
    return Transition(
        obs=data.obs[idx],
        action=data.action[idx],
        reward=ret,
        next_obs=data.next_obs[last_gidx],
        done=data.done[last_gidx],
        episode_done=data.episode_done[last_gidx],
    ), eff_gamma


class NStepAccumulator:
    """Namespace bundling the functions above (the JAX package's name)."""

    count = staticmethod(nstep_count)
    sample_range = staticmethod(nstep_sample_range)
    fold = staticmethod(nstep_fold)
