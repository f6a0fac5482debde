"""Multi-objective environments (counterpart: ``freerl_tpu/envs/mo.py``).

``DeepSeaTreasure`` is mo-gymnasium's ``deep-sea-treasure-v0``, as the
JAX package re-derives it: the classic 11x11 submarine grid with the
convex treasure set; actions {0: up, 1: down, 2: left, 3: right}; the
vector reward ``[treasure value, -1 time penalty]``; an episode
terminates on a treasure and truncates at 100 steps. The observation is
the (row, col) position as float32. The env is deterministic: its reset
and step take no draw (``draw_reset`` hands back a placeholder that
carries only the batch size).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.envs.base import Env

# the classic DST treasure map: (row, col, value)
_TREASURES = [
    (1, 0, 0.7), (2, 1, 8.2), (3, 2, 11.5), (4, 3, 14.0), (4, 4, 15.1),
    (4, 5, 16.1), (7, 6, 19.6), (7, 7, 20.3), (9, 8, 22.4), (10, 9, 23.7),
]
_ROWS, _COLS = 11, 11


def _build_maps():
    value = np.zeros((_ROWS, _COLS), np.float32)
    for r, c, v in _TREASURES:
        value[r, c] = v
    # seabed: cells below the treasure of each column are unreachable
    depth = np.full((_COLS,), _ROWS, np.int32)
    for r, c, _ in _TREASURES:
        depth[c] = r
    return value, depth


_VALUE_MAP, _DEPTH = _build_maps()


@dataclasses.dataclass
class DSTState:
    row: torch.Tensor
    col: torch.Tensor
    t: torch.Tensor


class DeepSeaTreasure(Env):
    """deep-sea-treasure-v0: a 2-objective grid world."""

    name = "deep-sea-treasure-v0"
    max_steps = 100
    reward_dim = 2
    # the training curve's scalarization, the reference's w_set_1
    record_weights = (0.5, 0.5)
    dim_info = DimInfo(obs_dim=2, action_dim=4, is_continue=False)

    def __init__(self, device="cuda"):
        super().__init__(device)
        self.value_map = torch.as_tensor(_VALUE_MAP, device=self.device)
        self.depth = torch.as_tensor(_DEPTH, device=self.device)
        self._dr = torch.tensor([-1, 1, 0, 0], dtype=torch.int32,
                                device=self.device)
        self._dc = torch.tensor([0, 0, -1, 1], dtype=torch.int32,
                                device=self.device)

    def draw_reset(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """No draw: a placeholder (n,) tensor that gives the batch size."""
        return torch.zeros(n, dtype=torch.int32, device=self.device)

    def key_reset_draw(self, key) -> torch.Tensor:
        """No draw: the JAX env's reset reads no key."""
        return self.draw_reset(1, None)

    def draw_step(self, n: int, generator: torch.Generator):
        return None

    def key_step_draw(self, keys):
        return None

    def reset(self, reset_draw: torch.Tensor):
        zero = torch.zeros_like(reset_draw, dtype=torch.int32)
        state = DSTState(row=zero, col=zero.clone(), t=zero.clone())
        return state, self.observation(state)

    def observation(self, state: DSTState) -> torch.Tensor:
        return torch.stack([state.row.to(torch.float32),
                            state.col.to(torch.float32)], dim=1)

    def step(self, state: DSTState, action: torch.Tensor, step_draw):
        action = action.to(torch.int64)
        row = torch.clamp(state.row + self._dr[action], 0, _ROWS - 1)
        col = torch.clamp(state.col + self._dc[action], 0, _COLS - 1)
        # cannot move below the seabed of the target column
        blocked = row > self.depth[col]
        row = torch.where(blocked, state.row, row)
        col = torch.where(blocked, state.col, col)
        new = DSTState(row=row, col=col, t=state.t + 1)
        treasure = self.value_map[row, col]
        reward = torch.stack([treasure, torch.full_like(treasure, -1.0)],
                             dim=1)
        terminated = treasure > 0
        truncated = (new.t >= self.max_steps) & ~terminated
        return new, self.observation(new), reward, terminated, truncated
