"""Episode rendering to GIF (counterpart: ``freerl_tpu/train/render.py``).

The reference's evaluate.py replays one random episode with
``render_mode='rgb_array'`` and writes ``evaluate.gif`` through imageio.
The port's envs are batched tensor state machines with no renderer, so
frames are drawn from the state trace with matplotlib: views for the
classic-control, lunar-lander and MPE families and a phase-space fallback
for everything else.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from freerl_tpu_torch.envs.base import Env
from freerl_tpu_torch.train.evaluate import (default_remap01, rollout_draws,
                                             run_episodes)


def _stack(states: Sequence):
    """States of batch 1 over T -> one state with (T, ...) numpy fields."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return torch.stack([s[0] for s in states]).cpu().numpy()
    return type(first)(**{name: _stack([getattr(s, name) for s in states])
                          for name in vars(first)})


def _row(trace, j: int, device):
    """Step ``j`` of a stacked trace as a state of batch 1 on ``device``."""
    if isinstance(trace, np.ndarray):
        return torch.as_tensor(trace[j:j + 1], device=device)
    return type(trace)(**{name: _row(v, j, device)
                          for name, v in vars(trace).items()})


def rollout_trace(env: Env, act_fn: Callable, seed: int = 0,
                  max_steps: Optional[int] = None,
                  remap01: Optional[bool] = None, carry_init=None,
                  draws: Optional[tuple] = None):
    """Play ONE episode; return (the state dataclass stacked over T, its
    fields numpy arrays of shape (T, ...); the return, a scalar or (A,);
    the length).

    ``act_fn(obs) -> action`` takes a batch of one observation, (1, ...),
    so ``algo.evaluate_action`` composes directly; a recurrent policy
    passes ``carry_init`` (``algo.init_policy_carry(1)``) and an
    ``act_fn(obs, carry) -> (action, carry)``, as in
    ``train/evaluate.py``. The draws come from a generator seeded with
    ``seed``, or from ``draws = (reset_draw, step_draws)``. A finished
    episode freezes until step T.
    """
    T = max_steps or env.max_steps
    if remap01 is None:
        remap01 = default_remap01(env)
    if draws is None:
        generator = torch.Generator(device=env.device).manual_seed(seed)
        draws = rollout_draws(env, 1, T, generator)
    trace = []
    ret = run_episodes(env, act_fn, 1, T, getattr(env, "n_agents", 1) > 1,
                       remap01, carry_init, draws, trace)
    dones = torch.cat([done for _, done in trace])
    # an episode that never finished within T has the whole trace
    length = min(int(dones.logical_not().sum()) + 1, T)
    return _stack([s for s, _ in trace]), ret[0].cpu().numpy(), length


# ---------------------------------------------------------------------------
def _fig_to_rgb(fig):
    fig.canvas.draw()
    w, h = fig.canvas.get_width_height()
    buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    return buf.reshape(h, w, 4)[..., :3].copy()


def _draw_cartpole(ax, s, i):
    from matplotlib.patches import Rectangle

    x, theta = float(s.x[i]), float(s.theta[i])
    ax.set_xlim(-2.6, 2.6)
    ax.set_ylim(-0.5, 1.5)
    ax.plot([-2.4, 2.4], [0, 0], color="k", lw=1)
    ax.add_patch(Rectangle((x - 0.2, -0.1), 0.4, 0.2, color="tab:blue"))
    ax.plot([x, x + np.sin(theta)], [0.0, np.cos(theta)],
            color="tab:orange", lw=4)


def _draw_mountain_car(ax, s, i):
    pos = float(s.position[i])
    xs = np.linspace(-1.2, 0.6, 100)
    ax.plot(xs, np.sin(3 * xs) * 0.45 + 0.55, color="k", lw=1)
    ax.plot([pos], [np.sin(3 * pos) * 0.45 + 0.57], "o", ms=10,
            color="tab:blue")
    ax.plot([0.5], [np.sin(3 * 0.5) * 0.45 + 0.6], "*", ms=14,
            color="tab:orange")
    ax.set_xlim(-1.3, 0.7)
    ax.set_ylim(0.0, 1.2)


def _draw_pendulum(ax, s, i):
    th = float(s.theta[i])
    ax.set_xlim(-1.3, 1.3)
    ax.set_ylim(-1.3, 1.3)
    ax.plot([0, np.sin(th)], [0, np.cos(th)], lw=5, color="tab:blue")
    ax.plot([0], [0], "ko", ms=6)


def _draw_lander(ax, s, i):
    x, y, ang = float(s.x[i]), float(s.y[i]), float(s.angle[i])
    ax.set_xlim(-1.2, 1.2)
    ax.set_ylim(-0.2, 1.6)
    ax.plot([-0.25, 0.25], [0, 0], color="tab:orange", lw=3)  # pad
    ax.plot([-1.2, 1.2], [0, 0], color="k", lw=1)
    dx, dy = 0.09 * np.cos(ang), 0.09 * np.sin(ang)
    ax.plot([x - dx, x + dx], [y - dy, y + dy], lw=6, color="tab:blue")


def _draw_mpe(ax, s, i, env):
    from matplotlib.patches import Circle

    pos = s.pos[i]
    ax.set_xlim(-1.5, 1.5)
    ax.set_ylim(-1.5, 1.5)
    n_agents = env.n_agents
    sizes = env.sizes.cpu().numpy()
    collide = env.coll_mask.any(dim=1).cpu().numpy()
    for e in range(pos.shape[0]):
        color = (f"C{e}" if e < n_agents
                 else ("0.6" if collide[e] else "0.85"))
        ax.add_patch(Circle(pos[e], float(sizes[e]), color=color,
                            alpha=0.9 if e < n_agents else 0.5))


def _draw_fallback(ax, trace, i):
    obs = trace[: i + 1]
    ax.plot(obs[:, 0], obs[:, 1] if obs.shape[1] > 1 else obs[:, 0],
            color="tab:blue", lw=1)
    ax.plot([obs[-1, 0]], [obs[-1, 1] if obs.shape[1] > 1 else obs[-1, 0]],
            "o", color="tab:orange")


def render_episode_gif(env: Env, act_fn: Callable, out_path: str,
                       seed: int = 0, fps: int = 25,
                       max_steps: Optional[int] = None,
                       carry_init=None) -> str:
    """Replay one episode (:func:`rollout_trace`; ``act_fn`` on a batch of
    one) and write it as a GIF."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    inner = getattr(env, "env", env)   # unwrap DisToConWrapper
    states, _, length = rollout_trace(env, act_fn, seed, max_steps,
                                      carry_init=carry_init)
    length = min(length, 400)          # keep the artifact small

    mpe = hasattr(states, "pos") and getattr(inner, "n_agents", 1) > 1
    known = (hasattr(states, "theta") or hasattr(states, "position")
             or hasattr(states, "leg1") or mpe)
    obs_trace = None
    if not known:
        obs_trace = np.concatenate([
            env.observation(_row(states, j, env.device)).reshape(1, -1)
            .cpu().numpy() for j in range(length)])
    frames = []
    fig, ax = plt.subplots(figsize=(4, 4), dpi=64)
    for i in range(length):
        ax.clear()
        ax.set_aspect("equal")
        ax.set_xticks([])
        ax.set_yticks([])
        if hasattr(states, "theta") and hasattr(states, "x"):
            _draw_cartpole(ax, states, i)
        elif hasattr(states, "position"):
            _draw_mountain_car(ax, states, i)
        elif hasattr(states, "theta"):
            _draw_pendulum(ax, states, i)
        elif hasattr(states, "leg1"):
            _draw_lander(ax, states, i)
        elif mpe:
            _draw_mpe(ax, states, i, inner)
        else:
            _draw_fallback(ax, obs_trace, i)
        ax.set_title(f"{env.name}  t={i}", fontsize=8)
        frames.append(_fig_to_rgb(fig))
    plt.close(fig)

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    import imageio

    imageio.mimsave(out_path, frames, fps=fps, loop=0)
    return out_path
