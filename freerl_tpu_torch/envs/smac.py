"""SMAC-protocol host bridge and a fake SMAC env for end-to-end tests
(counterpart: ``freerl_tpu/envs/smac.py``).

The reference trains masked MAPPO on SMACv2: the env exposes ``reset()``,
``get_obs() -> (n_agents, obs_dim)``, ``get_avail_actions() -> (n_agents,
n_actions)``, ``step(actions) -> (shared_reward, done, info)`` and
``get_env_info()`` with n_agents / n_actions / obs_shape / episode_limit.

- :class:`HostSmacVecEnv` steps M copies of any env speaking that protocol
  on the host (the ``envs/host.py`` pattern) and appends each agent's
  availability mask to its obs tail, so masked MAPPO
  (``MAPPOConfig(masked=True, mask_dim=n_actions)``) trains on it with no
  schema change. Point it at a real SMACv2 constructor on a machine that
  has the binary and the same training script runs.
- :class:`FakeSmacEnv` is a numpy implementation of the protocol: random
  availability per step, a shared team reward for picking the
  highest-index available action. It counts any invalid action it
  receives, so a test can show the masked pipeline never samples an
  unavailable action. Under one seed it draws exactly what the JAX
  package's class draws.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.envs.host import HostBridge


class FakeSmacEnv:
    """SMAC-protocol toy: pick the highest-index available action.

    Per step each agent sees a random availability pattern over
    ``n_actions`` (action 0 = noop, always available; each other action
    available with p=0.5). Obs = the availability vector itself. The team
    reward is the count of agents that chose the highest-index available
    action. ``invalid_actions_received`` counts protocol violations (an
    agent acting outside its mask).

    Like real SMAC, ``get_state()`` carries information the per-agent
    observations do not: a hidden per-step reward multiplier (1x or 2x,
    p=0.5), so a state-augmented critic (``use_state``) can explain reward
    variance a concat-obs critic cannot.
    """

    def __init__(self, n_agents: int = 3, n_actions: int = 5,
                 episode_limit: int = 25, seed: int = 0):
        self.n_agents = n_agents
        self.n_actions = n_actions
        self.episode_limit = episode_limit
        self._rng = np.random.default_rng(seed)
        self._t = 0
        self._avail = None
        self._bonus = 0.0
        self.invalid_actions_received = 0

    def get_env_info(self):
        return {
            "n_agents": self.n_agents,
            "n_actions": self.n_actions,
            "obs_shape": self.n_actions,
            "state_shape": self.n_agents * self.n_actions + 1,
            "episode_limit": self.episode_limit,
        }

    def _roll_avail(self):
        avail = (self._rng.random((self.n_agents, self.n_actions))
                 < 0.5).astype(np.float32)
        avail[:, 0] = 1.0
        self._avail = avail
        self._bonus = float(self._rng.random() < 0.5)

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._roll_avail()

    def get_obs(self):
        return self._avail.copy()

    def get_state(self):
        # the avail concat plus the hidden multiplier bit the agents cannot
        # observe (real SMAC's state is likewise richer than the obs)
        return np.concatenate(
            [self._avail.reshape(-1), [self._bonus]]).astype(np.float32)

    def get_avail_actions(self):
        return self._avail.copy()

    def step(self, actions):
        actions = np.asarray(actions, np.int64)
        avail = self._avail
        valid = avail[np.arange(self.n_agents), actions] > 0
        self.invalid_actions_received += int((~valid).sum())
        best = (avail * np.arange(self.n_actions)).max(axis=1)
        reward = float(np.sum(valid & (actions == best)))
        reward *= 1.0 + self._bonus          # hidden 2x rounds
        self._t += 1
        done = self._t >= self.episode_limit
        self._roll_avail()
        return reward, done, {}


class HostSmacVecEnv(HostBridge):
    """M SMAC-protocol host envs stepped in lockstep.

    The multi-agent driver contract (``train/onpolicy.py``): obs
    ``(M, A, obs_dim + n_actions)`` with the availability mask on the
    tail, a per-agent reward ``(M, A)`` (the shared SMAC reward tiled, as
    the reference logs it), a ``(M,)`` done, auto-reset on the host.
    """

    action_space_01 = False

    def __init__(self, make_fn: Callable, num_envs: int,
                 use_state: bool = False, device="cuda"):
        """``use_state``: also broadcast the env's global state
        (``get_state()``, on real SMAC richer than the obs concat) into
        each agent's obs as [raw_obs, state, mask], for the
        state-augmented centralized critic
        (``MAPPOConfig(state_dim=env.state_dim)``)."""
        super().__init__(device)
        self.make_fn = make_fn
        self.num_envs = num_envs
        self.use_state = use_state
        self._envs = [make_fn() for _ in range(num_envs)]
        info = self._envs[0].get_env_info()
        self.n_agents = int(info["n_agents"])
        self.n_actions = int(info["n_actions"])
        raw_obs = int(info["obs_shape"])
        self.max_steps = int(info["episode_limit"])
        self.state_dim = int(info["state_shape"]) if use_state else 0
        # per agent [raw_obs, state?, mask]: the mask stays on the tail,
        # so the masked-logits slicing is unchanged
        obs_dim = raw_obs + self.state_dim + self.n_actions
        self.agent_obs_dims = (obs_dim,) * self.n_agents
        self.agent_act_dims = (self.n_actions,) * self.n_agents
        self.dim_info = DimInfo(obs_dim=obs_dim, action_dim=self.n_actions,
                                is_continue=False)
        self.reward_threshold = None
        self.name = "HostSmacVecEnv"

    # ------------------------------------------------------------------
    @property
    def invalid_actions_received(self) -> int:
        return sum(e.invalid_actions_received for e in self._envs
                   if hasattr(e, "invalid_actions_received"))

    def _obs_of(self, e) -> np.ndarray:
        obs = np.asarray(e.get_obs(), np.float32)
        mask = np.asarray(e.get_avail_actions(), np.float32)
        if self.use_state:
            state = np.asarray(e.get_state(), np.float32)
            state = np.broadcast_to(state, (self.n_agents, state.size))
            return np.concatenate([obs, state, mask], axis=-1)
        return np.concatenate([obs, mask], axis=-1)

    def _host_reset(self, seed: int) -> np.ndarray:
        obs = []
        for i, e in enumerate(self._envs):
            e.reset(seed=int(seed) + i)
            obs.append(self._obs_of(e))
        return np.stack(obs)

    def _host_step(self, actions: np.ndarray):
        actions = np.asarray(actions)
        next_obs, carry_obs, rewards, terms = [], [], [], []
        for e, a in zip(self._envs, actions):
            r, done, _ = e.step(a)
            o2 = self._obs_of(e)
            next_obs.append(o2)
            if done:
                e.reset()
                carry_obs.append(self._obs_of(e))
            else:
                carry_obs.append(o2)
            rewards.append(np.full((self.n_agents,), r, np.float32))
            terms.append(bool(done))
        terms = np.asarray(terms)
        return (np.stack(next_obs), np.stack(carry_obs), np.stack(rewards),
                terms, np.zeros_like(terms))
