"""Action-masked multi-agent envs (counterpart:
``freerl_tpu/envs/masked.py``).

- :class:`ActionMaskWrapper` appends each agent's 0/1 availability mask to
  its observation, so a rollout carries the masks with no change to its
  layout;
- :func:`MaskedSpread` is the toy masked env: discrete simple_spread where
  a move that would take an agent past the +-1.2 arena is unavailable.
"""
from __future__ import annotations

import torch

from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.envs.base import Env, _Wrapper
from freerl_tpu_torch.envs.mpe import SimpleSpread


class ActionMaskWrapper(_Wrapper):
    """Append each agent's availability mask to its observation.

    ``mask_fn(env, state) -> (B, n_agents, n_actions)`` with 1 = available.
    Policies read it from the obs tail (``mask_dim`` = n_actions).
    """

    def __init__(self, env: Env, mask_fn):
        super().__init__(env)
        self.mask_fn = mask_fn
        self.mask_dim = env.dim_info.action_dim
        self.agent_obs_dims = tuple(d + self.mask_dim
                                    for d in env.agent_obs_dims)
        self.dim_info = DimInfo(
            obs_dim=env.dim_info.obs_dim + self.mask_dim,
            action_dim=env.dim_info.action_dim,
            is_continue=env.dim_info.is_continue,
            max_action=env.dim_info.max_action,
        )
        self.name = env.name + "-masked"

    def _augment(self, state, obs: torch.Tensor) -> torch.Tensor:
        mask = self.mask_fn(self.env, state).to(torch.float32)
        return torch.cat([obs, mask], dim=-1)

    def reset(self, reset_draw: torch.Tensor):
        state, obs = self.env.reset(reset_draw)
        return state, self._augment(state, obs)

    def step(self, state, action, step_draw):
        new, obs, r, term, trunc = self.env.step(state, action, step_draw)
        return new, self._augment(new, obs), r, term, trunc

    def observation(self, state):
        return self._augment(state, self.env.observation(state))


def _bound_mask(env, state) -> torch.Tensor:
    """Moves that would leave the +-1.2 arena are unavailable (discrete MPE
    actions: 0 noop, 1 +x, 2 -x, 3 +y, 4 -y)."""
    pos = state.pos[:, :env.n_agents]                   # (B, A, 2)
    lim = 1.2
    ok_px, ok_nx = pos[..., 0] < lim, pos[..., 0] > -lim
    ok_py, ok_ny = pos[..., 1] < lim, pos[..., 1] > -lim
    return torch.stack([torch.ones_like(ok_px), ok_px, ok_nx, ok_py, ok_ny],
                       dim=-1)


def MaskedSpread(N: int = 3, device="cuda") -> ActionMaskWrapper:
    return ActionMaskWrapper(
        SimpleSpread(N=N, continuous_actions=False, device=device),
        _bound_mask)
