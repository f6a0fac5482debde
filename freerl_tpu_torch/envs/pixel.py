"""Pixel observations with frame stacking, on the device (counterpart:
``freerl_tpu/envs/pixel.py``).

``PixelCartPole`` is the port's CartPole-v1 rendered at 48x48 grayscale
(cart body, pole segment, track line) with a 2-frame stack, so velocity
shows in the difference of the two frames. The last ``n_stack`` frames
ride in the env state, and the observation is the stack flattened in
channel-last order, ``(H, W, n_stack)`` (``obs_shape``), so the replay and
rollout machinery takes pixels as it takes any flat observation. The
renderer runs the JAX package's float operations in its order on a batch
of envs; the draws are CartPole's.
"""
from __future__ import annotations

import dataclasses

import torch

from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.envs.base import Env
from freerl_tpu_torch.envs.classic import CartPole, CartPoleState


@dataclasses.dataclass
class PixelCartPoleState:
    inner: CartPoleState
    frames: torch.Tensor      # (B, n_stack, H, W), newest last


class PixelCartPole(Env):
    """CartPole from 48x48x2 stacked grayscale frames."""

    name = "PixelCartPole-v1"
    H = W = 48
    n_stack = 2
    max_steps = 500
    reward_threshold = 475.0
    dim_info = DimInfo(obs_dim=n_stack * H * W, action_dim=2,
                       is_continue=False)
    obs_shape = (H, W, n_stack)   # channel-last view for conv trunks

    def __init__(self, device="cuda"):
        super().__init__(device)
        self._inner = CartPole(device=device)
        H, W = self.H, self.W
        self._xs = torch.arange(W, dtype=torch.float32,
                                device=self.device)[None, None, :]
        self._ys = torch.arange(H, dtype=torch.float32,
                                device=self.device)[None, :, None]
        # the track line, the same in every frame
        self._track = torch.where(torch.abs(self._ys - (H - 7.0)) < 0.6,
                                  0.3, 0.0) * torch.ones((H, W),
                                                         device=self.device)

    # -- rendering -------------------------------------------------------
    def render_frame(self, inner: CartPoleState) -> torch.Tensor:
        """(B, H, W) grayscale in [0, 1]: track, cart, pole."""
        H, W = self.H, self.W
        xs, ys = self._xs, self._ys
        # world -> pixel: x in [-2.4, 2.4] -> [4, W - 4]
        px_per_unit = (W - 8) / 4.8
        cart_px = ((inner.x + 2.4) * px_per_unit + 4.0)[:, None, None]
        cart_py = H - 10.0                                # cart centre row
        # cart: a 7x3 rectangle
        cart = (torch.abs(xs - cart_px) < 3.5) & (torch.abs(ys - cart_py)
                                                  < 2.0)
        img = torch.where(cart, 1.0, self._track)
        # pole: a segment from the cart centre, ~0.8*H/2 px long at angle
        # theta (theta 0 is upright; screen y grows downward)
        plen = 0.8 * H / 2.0
        dx = torch.sin(inner.theta)[:, None, None]
        dy = -torch.cos(inner.theta)[:, None, None]
        rx = xs - cart_px
        ry = ys - cart_py
        tproj = torch.clamp(rx * dx + ry * dy, 0.0, plen)
        dist2 = (rx - tproj * dx) ** 2 + (ry - tproj * dy) ** 2
        return torch.where(dist2 < 1.2**2, 0.7, img)

    def _obs(self, frames: torch.Tensor) -> torch.Tensor:
        # (B, n_stack, H, W) -> flat, channel-last (H, W, n_stack)
        return frames.permute(0, 2, 3, 1).reshape(frames.shape[0], -1)

    # -- Env protocol ----------------------------------------------------
    def draw_reset(self, n: int, generator: torch.Generator) -> torch.Tensor:
        return self._inner.draw_reset(n, generator)

    def key_reset_draw(self, key) -> torch.Tensor:
        return self._inner.key_reset_draw(key)

    def draw_step(self, n: int, generator: torch.Generator):
        return self._inner.draw_step(n, generator)

    def key_step_draw(self, keys):
        return self._inner.key_step_draw(keys)

    def reset(self, reset_draw: torch.Tensor):
        inner, _ = self._inner.reset(reset_draw)
        frame = self.render_frame(inner)
        frames = frame[:, None].expand(-1, self.n_stack, -1, -1).contiguous()
        return PixelCartPoleState(inner=inner, frames=frames), \
            self._obs(frames)

    def observation(self, state: PixelCartPoleState) -> torch.Tensor:
        return self._obs(state.frames)

    def step(self, state: PixelCartPoleState, action: torch.Tensor,
             step_draw):
        inner, _, reward, term, trunc = self._inner.step(state.inner, action,
                                                         step_draw)
        frames = torch.cat([state.frames[:, 1:],
                            self.render_frame(inner)[:, None]], dim=1)
        new = PixelCartPoleState(inner=inner, frames=frames)
        return new, self._obs(frames), reward, term, trunc
