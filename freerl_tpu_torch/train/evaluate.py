"""Offline evaluation harness (counterpart:
``freerl_tpu/train/evaluate.py``).

- re-run N=100 episodes the policy never trained on, scored against the
  env's ``reward_threshold`` goal line;
- the exp-smoothed evaluation plot, ``evaluate.png``;
- the multi-agent twin, with per-agent returns.

The rollout is one batch of ``n_episodes`` envs stepped for
``env.max_steps`` vector steps on the env's device; a finished episode
freezes (its state, obs and return stop changing) until the batch ends.
Its episodes are the JAX package's for the same ``seed0``: the same reset
and step draws, recomputed from the same ``jax.random`` keys on the host
(``jax_draws``).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from freerl_tpu_torch.core import jax_prng
from freerl_tpu_torch.envs.base import Env, _select, row_mask


def default_remap01(env: Env) -> bool:
    """Whether continuous actions go from [-1, 1] to the env's [0, 1] box
    (the MPE scenarios)."""
    return bool(getattr(env, "action_space_01", False)
                and env.dim_info.is_continue)


def rollout_draws(env: Env, n: int, steps: int, generator: torch.Generator):
    """(reset draw, [step draw per step]) of an ``n``-env, ``steps``-step
    rollout, made from ``generator``."""
    reset_draw = env.draw_reset(n, generator)
    return reset_draw, [env.draw_step(n, generator) for _ in range(steps)]


def jax_draws(env: Env, n: int, steps: int, seed0: int):
    """(reset draw, [step draw per step]) of the JAX package's evaluation
    from ``seed0`` (``freerl_tpu/train/evaluate.py``): each episode resets
    from a key of ``split(PRNGKey(seed0), n)``, and step t draws from the
    keys of ``split(fold_in(PRNGKey(seed0 + 7), t), n)``. Made on the host
    (``env.key_reset_draw``, ``env.key_step_draw``), then moved to the
    env's device in one copy each."""
    keys = jax_prng.split(jax_prng.prng_key(seed0), n)
    reset_draw = torch.cat([env.key_reset_draw(k) for k in keys])
    step_keys = jax_prng.split(jax_prng.fold_in(
        jax_prng.prng_key(seed0 + 7), np.arange(steps)), n)   # (T, n, 2)
    flat = env.key_step_draw(step_keys.reshape(-1, 2))
    if flat is None:
        return reset_draw, [None] * steps
    per_step = flat.reshape((steps, n) + flat.shape[1:])
    return reset_draw, list(per_step.unbind(0))


@torch.no_grad()
def run_episodes(env: Env, act_fn, n: int, steps: int, per_agent: bool,
                 remap01: bool, carry_init, draws: tuple,
                 trace: Optional[list] = None) -> torch.Tensor:
    """Step ``n`` envs for ``steps`` vector steps without auto-reset; a
    finished episode freezes (state, obs and return). Returns the (n,)
    returns, or (n, A) with ``per_agent``; a reward with more dims than
    the return (a vector reward, or per-agent rewards summed into a team
    return) is summed over its last axis. ``trace``, where given, gets the
    (state, done) after each step."""
    reset_draw, step_draws = draws
    state, obs = env.reset(reset_draw)
    ret = torch.zeros((n, env.n_agents) if per_agent else (n,),
                      device=env.device)
    done = torch.zeros(n, dtype=torch.bool, device=env.device)
    carry = carry_init
    for t in range(steps):
        if carry_init is not None:
            action, carry = act_fn(obs, carry)
        else:
            action = act_fn(obs)
        if remap01:
            action = (action + 1.0) / 2.0
        state2, obs2, r, term, trunc = env.step(state, action, step_draws[t])
        if r.dim() > ret.dim():
            r = r.sum(dim=-1)
        ret = ret + r * row_mask(~done, r)
        done = done | term | trunc
        state = _select(done, state, state2)
        obs = torch.where(row_mask(done, obs2), obs, obs2)
        if trace is not None:
            trace.append((state, done))
    return ret


def evaluate(env: Env, act_fn, n_episodes: int = 100, seed0: int = 0,
             max_steps: Optional[int] = None, multi_agent: bool = False,
             remap01: Optional[bool] = None, carry_init=None,
             draws: Optional[tuple] = None):
    """Score a policy over ``n_episodes`` held-out episodes.

    ``act_fn(obs) -> action`` is a deterministic batched policy (the
    reference's ``evaluate_action``). A recurrent policy (``algos/
    rmappo.py``) passes ``carry_init`` (``algo.init_policy_carry(
    n_episodes)``) and an ``act_fn(obs, carry) -> (action, carry)``;
    episodes never reset mid-rollout (finished ones freeze), so no hidden
    resets are needed. The episodes are the JAX package's held-out ones for
    ``seed0`` (``jax_draws``), or those of ``draws = (reset_draw,
    step_draws)`` (``step_draws[t]`` for step t; ``rollout_draws`` makes
    them from a generator). An env that seeds itself on the host (the host
    bridge, ``envs/host.py``, and SMAC: their JAX counterparts seed
    themselves outside ``jax.random`` too) draws from a generator seeded
    with ``seed0``; any other env without the JAX key draws raises
    ``NotImplementedError``. A vector (multi-objective) reward is
    scalarized by its sum. Returns (n_episodes,) returns, or (n_episodes,
    n_agents) with ``multi_agent``.
    """
    T = max_steps or env.max_steps
    if remap01 is None:
        remap01 = default_remap01(env)
    if draws is None and getattr(env, "host_seeded", False):
        generator = torch.Generator(device=env.device).manual_seed(seed0)
        draws = rollout_draws(env, n_episodes, T, generator)
    elif draws is None:
        draws = jax_draws(env, n_episodes, T, seed0)
    ret = run_episodes(env, act_fn, n_episodes, T, multi_agent, remap01,
                       carry_init, draws)
    return ret.cpu().numpy()


def plot_evaluate(returns: np.ndarray, goal: Optional[float] = None,
                  out_path: str = "evaluate.png", alpha: float = 0.9):
    """Exp-smoothed per-episode evaluation plot with the threshold goal
    line."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from freerl_tpu_torch.train.plotting import exp_smooth

    smoothed = exp_smooth(np.asarray(returns), alpha)
    fig, ax = plt.subplots(figsize=(8, 4.5))
    ax.plot(returns, alpha=0.3, label="return")
    ax.plot(smoothed, label=f"smoothed (a={alpha})")
    if goal is not None:
        ax.axhline(goal, color="red", ls="--", label=f"goal {goal}")
    ax.set_xlabel("episode")
    ax.set_ylabel("return")
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path
