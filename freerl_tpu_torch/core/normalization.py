"""Running-statistics normalizers (counterpart:
``freerl_tpu/core/normalization.py``).

- ``RunningMeanStd``: parallel-Welford running mean and variance over a
  feature axis; one implementation covers the per-sample and the batch
  observation normalizers of the reference.
- ``RewardScaling``: divide by the running std of the discounted return, no
  mean subtraction, the return reset where an episode ends.
- ``PopArt``: the statistics of a normalized-target critic head, and the
  (scale, shift) that rescale the head so its denormalized outputs are
  preserved.

The state is device tensors and every update runs on the device; the
objects are functional, as in the JAX package: an update returns a new
object. Batch moments use the population variance, ``torch.var(...,
correction=0)``, as ``jnp.var`` does (torch's default is the unbiased
one). With ``axis_name`` (a mesh of ``distributed/dp.py``) an update folds
the GLOBAL batch: its moments are all-reduced over the ranks first, so
the stats stay replicated.
"""
from __future__ import annotations

import dataclasses

import torch

from freerl_tpu_torch.distributed.dp import pmean, psum


def _moments(x: torch.Tensor):
    """Batch count, mean and population variance over the leading axis."""
    return (float(x.shape[0]), torch.mean(x, dim=0),
            torch.var(x, dim=0, correction=0))


@dataclasses.dataclass
class RunningMeanStd:
    """Parallel-Welford running first and second moments."""

    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor            # scalar float32

    @classmethod
    def create(cls, shape, device="cuda") -> "RunningMeanStd":
        return cls(
            mean=torch.zeros(shape, device=device),
            var=torch.ones(shape, device=device),
            count=torch.full((), 1e-4, device=device),
        )

    def update(self, batch: torch.Tensor,
               axis_name: str | None = None) -> "RunningMeanStd":
        """Fold a batch of samples (leading axes are batch axes) in. With
        ``axis_name`` the batch moments are first merged over the ranks
        (the law of total variance over equal-size shards), so every rank
        folds the global batch."""
        x = batch.reshape((-1,) + tuple(self.mean.shape))
        b_count, b_mean, b_var = _moments(x)
        if axis_name is not None:
            g_mean = pmean(b_mean, axis_name)
            b_var = pmean(b_var + torch.square(b_mean - g_mean), axis_name)
            b_mean = g_mean
            b_count = psum(torch.tensor(b_count, device=x.device),
                           axis_name)
        delta = b_mean - self.mean
        tot = self.count + b_count
        new_mean = self.mean + delta * (b_count / tot)
        m_a = self.var * self.count
        m_b = b_var * b_count
        m2 = m_a + m_b + torch.square(delta) * (self.count * b_count / tot)
        return RunningMeanStd(mean=new_mean, var=m2 / tot, count=tot)

    def normalize(self, x: torch.Tensor,
                  clip: float | None = None) -> torch.Tensor:
        y = (x - self.mean) / torch.sqrt(self.var + 1e-8)
        if clip is not None:
            y = torch.clamp(y, -clip, clip)
        return y

    def denormalize(self, y: torch.Tensor) -> torch.Tensor:
        return y * torch.sqrt(self.var + 1e-8) + self.mean


@dataclasses.dataclass
class RewardScaling:
    """Scale rewards by the running std of the discounted return
    ``R <- gamma*R + r`` (per env), with ``R`` reset where an episode
    ends."""

    stats: RunningMeanStd
    ret: torch.Tensor              # (num_envs,) running discounted return
    gamma: float = 0.99

    @classmethod
    def create(cls, num_envs: int, gamma: float,
               device="cuda") -> "RewardScaling":
        return cls(stats=RunningMeanStd.create((), device),
                   ret=torch.zeros(num_envs, device=device), gamma=gamma)

    def __call__(self, reward: torch.Tensor, episode_done: torch.Tensor,
                 axis_name: str | None = None):
        ret = self.gamma * self.ret + reward
        stats = self.stats.update(ret, axis_name=axis_name)
        scaled = reward / torch.sqrt(stats.var + 1e-8)
        ret = torch.where(episode_done, 0.0, ret)
        return RewardScaling(stats=stats, ret=ret, gamma=self.gamma), scaled


@dataclasses.dataclass
class PopArt:
    """Preserving-Outputs-Precisely Adaptive-Rescaling-of-Targets."""

    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @classmethod
    def create(cls, shape=(), device="cuda") -> "PopArt":
        return cls(
            mean=torch.zeros(shape, device=device),
            var=torch.ones(shape, device=device),
            count=torch.full((), 1e-4, device=device),
        )

    @property
    def std(self) -> torch.Tensor:
        return torch.sqrt(self.var + 1e-8)

    def adapt(self, targets: torch.Tensor):
        """Update the stats with a batch of (denormalized) targets. Returns
        ``(new_stats, scale, shift)``: the head transforms as
        ``w' = w * scale`` and ``b' = b * scale + shift``, with
        ``scale = old_std / new_std`` and
        ``shift = (old_mean - new_mean) / new_std``."""
        old_mean, old_std = self.mean, self.std
        x = targets.reshape((-1,) + tuple(self.mean.shape))
        b_count, b_mean, b_var = _moments(x)
        delta = b_mean - self.mean
        tot = self.count + b_count
        new_mean = self.mean + delta * (b_count / tot)
        m2 = self.var * self.count + b_var * b_count + torch.square(delta) * (
            self.count * b_count / tot
        )
        new = PopArt(mean=new_mean, var=m2 / tot, count=tot)
        scale = old_std / new.std
        shift = (old_mean - new.mean) / new.std
        return new, scale, shift

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / self.std

    def denormalize(self, y: torch.Tensor) -> torch.Tensor:
        return y * self.std + self.mean
