"""Tabular envs (FrozenLake, Taxi) as device-resident transition tables
(counterpart: ``freerl_tpu/envs/tabular.py``).

The integer state is fed to the agent as one float (obs_dim=1). The
dynamics are built once on the host as dense (S, A, K) next-state, reward,
probability and terminal tables over K stochastic outcomes per (s, a),
then moved to the device: a batched step is a handful of gathers.

Draws are arguments. ``reset`` takes the index of each row's start state;
``step`` takes Gumbel noise of shape (B, K) and picks the outcome
``argmax(gumbel + log(prob + 1e-12))``, which is how
``jax.random.categorical`` samples, so a test can feed in the JAX env's
Gumbel draws and step the same outcomes.

FrozenLake-v1: 4x4 map SFFF/FHFH/FFFH/HFFG, is_slippery=True (intended
move + both perpendiculars, 1/3 each), reward 1 at G, episode ends at
holes/goal, 100-step truncation.
Taxi-v3: the classic 5x5 gridworld, 500 states, deterministic; -1/step,
-10 illegal pickup/dropoff, +20 success, 200-step truncation.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.envs.base import Env


@dataclasses.dataclass
class TabularState:
    s: torch.Tensor      # (B,) int64 state index
    t: torch.Tensor      # (B,) int32 step counter


class _TabularEnv(Env):
    """next_state, reward, prob, terminal: (S, A, K) tables."""

    n_states: int

    def __init__(self, tables, start_states, device="cuda"):
        super().__init__(device)
        next_s, rew, prob, term = tables

        def dev(x, dtype):
            return torch.as_tensor(x, dtype=dtype, device=self.device)

        self.next_state = dev(next_s, torch.int64)
        self.reward = dev(rew, torch.float32)
        self.prob = dev(prob, torch.float32)
        self.log_prob = torch.log(self.prob + 1e-12)
        self.terminal = dev(term, torch.bool)
        self.start_states = dev(start_states, torch.int64)
        self.n_outcomes = next_s.shape[2]

    def draw_reset(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """Each row's start-state index, (n,), uniform."""
        return torch.randint(0, len(self.start_states), (n,),
                             generator=generator, device=self.device)

    def draw_step(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """Gumbel noise, (n, K): -log(-log(U)), U uniform on [tiny, 1)."""
        u = torch.rand((n, self.n_outcomes), generator=generator,
                       device=self.device)
        u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def reset(self, start_idx: torch.Tensor):
        s = self.start_states[start_idx]
        state = TabularState(s=s, t=torch.zeros(s.shape[0], dtype=torch.int32,
                                                device=self.device))
        return state, self.observation(state)

    def observation(self, state: TabularState) -> torch.Tensor:
        return state.s.to(torch.float32)[:, None]

    def step(self, state: TabularState, action: torch.Tensor,
             gumbel: torch.Tensor):
        s, a = state.s, action.reshape(-1).to(torch.int64)
        k = torch.argmax(gumbel + self.log_prob[s, a], dim=-1)
        s2 = self.next_state[s, a, k]
        r = self.reward[s, a, k]
        term = self.terminal[s, a, k]
        new = TabularState(s=s2, t=state.t + 1)
        trunc = (new.t >= self.max_steps) & ~term
        return new, self.observation(new), r, term, trunc


# ---------------------------------------------------------------------------
_FL_MAP = ["SFFF", "FHFH", "FFFH", "HFFG"]


def _build_frozenlake(slippery: bool = True):
    n = 4
    S, A = n * n, 4
    K = 3 if slippery else 1
    next_s = np.zeros((S, A, K), np.int64)
    rew = np.zeros((S, A, K), np.float32)
    prob = np.zeros((S, A, K), np.float32)
    term = np.zeros((S, A, K), bool)

    def move(s, a):
        r, c = divmod(s, n)
        if a == 0:
            c = max(c - 1, 0)          # left
        elif a == 1:
            r = min(r + 1, n - 1)      # down
        elif a == 2:
            c = min(c + 1, n - 1)      # right
        elif a == 3:
            r = max(r - 1, 0)          # up
        return r * n + c

    for s in range(S):
        cell = _FL_MAP[s // n][s % n]
        for a in range(A):
            outcomes = [(a - 1) % 4, a, (a + 1) % 4] if slippery else [a]
            for k, b in enumerate(outcomes):
                s2 = s if cell in "HG" else move(s, b)      # absorbing
                cell2 = _FL_MAP[s2 // n][s2 % n]
                next_s[s, a, k] = s2
                prob[s, a, k] = 1.0 / len(outcomes)
                rew[s, a, k] = 1.0 if (cell not in "HG" and cell2 == "G") else 0.0
                term[s, a, k] = cell2 in "HG"
    return next_s, rew, prob, term


class FrozenLake(_TabularEnv):
    name = "FrozenLake-v1"
    max_steps = 100
    reward_threshold = 0.7
    dim_info = DimInfo(obs_dim=1, action_dim=4, is_continue=False)
    n_states = 16

    def __init__(self, is_slippery: bool = True, device="cuda"):
        super().__init__(_build_frozenlake(is_slippery), np.array([0]), device)


# ---------------------------------------------------------------------------
# Taxi-v3: 5x5 grid, 4 depots R(0,0) G(0,4) Y(4,0) B(4,3), walls
_TAXI_LOCS = [(0, 0), (0, 4), (4, 0), (4, 3)]
# vertical walls between (row, col) and (row, col+1)
_TAXI_WALLS = {(0, 1), (1, 1), (3, 0), (4, 0), (3, 2), (4, 2)}


def _taxi_encode(row, col, pidx, didx):
    return ((row * 5 + col) * 5 + pidx) * 4 + didx


def _build_taxi():
    S, A = 500, 6
    next_s = np.zeros((S, A, 1), np.int64)
    rew = np.zeros((S, A, 1), np.float32)
    prob = np.ones((S, A, 1), np.float32)
    term = np.zeros((S, A, 1), bool)
    starts = []
    for row in range(5):
        for col in range(5):
            for pidx in range(5):          # 4 depots + 4=in taxi
                for didx in range(4):
                    s = _taxi_encode(row, col, pidx, didx)
                    if pidx < 4 and pidx != didx:
                        starts.append(s)
                    for a in range(A):
                        nr, nc, npi = row, col, pidx
                        r = -1.0
                        done = False
                        if a == 0:
                            nr = min(row + 1, 4)           # south
                        elif a == 1:
                            nr = max(row - 1, 0)           # north
                        elif a == 2:                        # east
                            if (row, col) not in _TAXI_WALLS:
                                nc = min(col + 1, 4)
                        elif a == 3:                        # west
                            if (row, col - 1) not in _TAXI_WALLS:
                                nc = max(col - 1, 0)
                        elif a == 4:                        # pickup
                            if pidx < 4 and (row, col) == _TAXI_LOCS[pidx]:
                                npi = 4
                            else:
                                r = -10.0
                        elif a == 5:                        # dropoff
                            if pidx == 4 and (row, col) == _TAXI_LOCS[didx]:
                                npi = didx
                                r = 20.0
                                done = True
                            elif pidx == 4 and (row, col) in _TAXI_LOCS:
                                npi = _TAXI_LOCS.index((row, col))
                                r = -10.0
                            else:
                                r = -10.0
                        next_s[s, a, 0] = _taxi_encode(nr, nc, npi, didx)
                        rew[s, a, 0] = r
                        term[s, a, 0] = done
    return (next_s, rew, prob, term), np.array(starts)


class Taxi(_TabularEnv):
    name = "Taxi-v3"
    max_steps = 200
    reward_threshold = 8.0
    dim_info = DimInfo(obs_dim=1, action_dim=6, is_continue=False)
    n_states = 500

    def __init__(self, device="cuda"):
        tables, starts = _build_taxi()
        super().__init__(tables, starts, device)
