"""Episode-major experience store (counterpart:
``freerl_tpu/buffers/episode.py``).

A fixed ``(capacity, horizon)`` ring of whole trajectories on the device.
Episodes arrive as stacked ``(T, ...)`` trajectories with a validity mask
derived from ``episode_done``: a step is valid up to and including the
first done step. ``all()`` returns the flattened store and its mask, so
variable-length episodes batch rectangularly (pad and mask).

``ep_pos`` and ``ep_count`` are host ints: each add carries a known number
of episodes. A batched ``add_episodes`` writes its N slots at once; where
N exceeds the capacity only the last ``capacity`` trajectories are
written, the ones the JAX package's sequential scan leaves standing (a
CUDA ``index_put_`` with duplicate indices gives no order).
"""
from __future__ import annotations

import dataclasses

import torch

from freerl_tpu_torch.core.types import Transition


def valid_mask(episode_done: torch.Tensor) -> torch.Tensor:
    """(..., T) episode ends -> (..., T) valid steps: those with no done
    strictly before them."""
    done = episode_done.to(torch.int32)
    ended_before = torch.cumsum(done, dim=-1) - done
    return ended_before == 0


@dataclasses.dataclass
class EpisodeBuffer:
    data: Transition            # tensors (capacity, horizon, ...)
    valid: torch.Tensor         # (capacity, horizon) bool
    capacity: int
    horizon: int
    ep_pos: int = 0             # next episode slot
    ep_count: int = 0           # episodes stored (<= capacity)

    @classmethod
    def create(cls, capacity: int, horizon: int,
               example: Transition) -> "EpisodeBuffer":
        """Allocate from one transition with no batch dim."""
        data = example.map(lambda x: torch.zeros(
            (capacity, horizon) + tuple(x.shape), dtype=x.dtype,
            device=x.device))
        valid = torch.zeros((capacity, horizon), dtype=torch.bool,
                            device=example.obs.device)
        return cls(data=data, valid=valid, capacity=capacity, horizon=horizon)

    # ------------------------------------------------------------------
    def add_episode(self, traj: Transition) -> "EpisodeBuffer":
        """Store one stacked (T, ...) trajectory in the next slot, in
        place; steps after its first ``episode_done`` are masked invalid."""
        return self.add_episodes(traj.map(lambda x: x[None]))

    def add_episodes(self, trajs: Transition) -> "EpisodeBuffer":
        """Store a batch of (N, T, ...) trajectories (vector envs), in
        place, in slots ``ep_pos``, ``ep_pos + 1``, ... modulo the
        capacity."""
        n, t = trajs.episode_done.shape[:2]
        if t != self.horizon:
            raise ValueError(f"trajectories of {t} steps in a buffer of "
                             f"horizon {self.horizon}")
        start = self.pos_after(n - min(n, self.capacity))
        if n > self.capacity:
            trajs = trajs.map(lambda x: x[n - self.capacity:])
        slots = (start + torch.arange(min(n, self.capacity),
                                      device=self.valid.device)) \
            % self.capacity
        for f in dataclasses.fields(Transition):
            getattr(self.data, f.name)[slots] = getattr(trajs, f.name)
        self.valid[slots] = valid_mask(trajs.episode_done)
        self.ep_pos = self.pos_after(n)
        self.ep_count = min(self.ep_count + n, self.capacity)
        return self

    def pos_after(self, n: int) -> int:
        return (self.ep_pos + n) % self.capacity

    # ------------------------------------------------------------------
    def all(self):
        """(flattened Transition (capacity * horizon, ...), mask
        (capacity * horizon,))."""
        flat = self.data.map(lambda x: x.reshape(
            (self.capacity * self.horizon,) + tuple(x.shape[2:])))
        return flat, self.valid.reshape(-1)

    def sample_idx(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """n episode slots, uniform with replacement over the stored ones."""
        return torch.randint(0, max(self.ep_count, 1), (n,),
                             generator=generator, device=self.valid.device)

    def gather(self, idx: torch.Tensor):
        """Whole episodes: (Transition (n, T, ...), mask (n, T))."""
        return self.data.map(lambda x: x[idx]), self.valid[idx]

    def sample_episodes(self, generator: torch.Generator, n: int):
        return self.gather(self.sample_idx(generator, n))

    def clear(self) -> "EpisodeBuffer":
        self.valid.zero_()
        self.ep_pos = self.ep_count = 0
        return self

    def __len__(self):
        return self.ep_count
