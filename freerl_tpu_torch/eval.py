"""Offline evaluation CLI (counterpart: ``freerl_tpu/eval.py``).

Loads a run directory written by ``python -m freerl_tpu_torch.cli`` (its
full-state checkpoint), replays ``--n_episodes`` held-out episodes through
the deterministic policy, and writes the reference's artifact set:

  - ``evaluate.png``: the exp-smoothed returns against the env's
    reward_threshold;
  - ``evaluate.gif``: one replayed episode, drawn from the state trace;
  - the console mean and std over the episodes (per agent for MARL).

Training runs write ``config.json``, so the only required flag is the run
directory: the env, the algorithm and every construction-affecting trick
come from it. Explicit flags override it; ``--device`` overrides the
device the run trained on, so a run trained on the card can be scored on
the CPU. :func:`score` is the scoring alone (no matplotlib or imageio).

Example:
  python -m freerl_tpu_torch.cli  --algo DQN --env_name CartPole-v1
  python -m freerl_tpu_torch.eval --model_dir results/CartPole-v1/DQN_1
"""
from __future__ import annotations

import argparse
import json
import os
from types import SimpleNamespace

import numpy as np
import torch

# fallbacks for run dirs without config.json (the training CLI's defaults)
_BUILD_DEFAULTS = dict(
    algo="DQN", env_name="CartPole-v1", trick=[], dis_to_con=False,
    discrete_actions=False, num_envs=8, horizon=2048,
    buffer_size=200_000, batch_size=64, max_episodes=500,
    lr=1e-3, gauss_sigma=0.1, noise_init_scale=None, device="cuda",
)


def _build_args(args) -> SimpleNamespace:
    """config.json < explicit CLI flags, over the CLI defaults."""
    merged = dict(_BUILD_DEFAULTS)
    cfg_path = os.path.join(args.model_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            saved = json.load(f)
        merged.update({k: v for k, v in saved.items() if k in merged})
    for k in _BUILD_DEFAULTS:
        v = getattr(args, k, None)
        if v is not None:
            merged[k] = v
    return SimpleNamespace(**merged)


def parse(argv=None) -> SimpleNamespace:
    """The evaluation's arguments: the construction flags merged by
    :func:`_build_args`, plus the evaluation's own."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_dir", required=True,
                   help="run dir holding 'checkpoint' (and config.json)")
    p.add_argument("--n_episodes", type=int, default=100)
    p.add_argument("--seed0", type=int, default=0,
                   help="seed of the evaluation's draws")
    p.add_argument("--gif", action="store_true", default=True)
    p.add_argument("--no_gif", dest="gif", action="store_false")
    p.add_argument("--gif_seed", type=int, default=None,
                   help="episode seed for the gif (default: random)")
    # construction flags: normally read from the run's config.json;
    # passing any of them explicitly overrides the saved value
    p.add_argument("--algo", default=None)
    p.add_argument("--env_name", default=None)
    p.add_argument("--trick", nargs="*", default=None)
    p.add_argument("--dis_to_con", action="store_true", default=None)
    p.add_argument("--discrete_actions", action="store_true", default=None)
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--horizon", type=int, default=None)
    p.add_argument("--buffer_size", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--max_episodes", type=int, default=None,
                   help="must match training (ENVELOPE schedules on it)")
    p.add_argument("--device", default=None,
                   help="torch device to score on (default: the run's)")
    p.add_argument("--preference", type=float, nargs="*", default=None,
                   help="ENVELOPE only: evaluation preference weights "
                        "(default: uniform over reward_dim)")
    cli = p.parse_args(argv)
    args = _build_args(cli)
    for k in ("model_dir", "n_episodes", "seed0", "gif", "gif_seed",
              "preference"):
        setattr(args, k, getattr(cli, k))
    return args


def load_policy(args):
    """(env, algo, act_fn, carry_fn) of the run: the env and algorithm
    built from ``args``, the checkpoint loaded into ``algo.init`` on a
    generator seeded with 0, a deterministic batched ``act_fn`` and, for a
    recurrent policy, ``carry_fn(n)`` giving its initial carry (else
    None)."""
    from freerl_tpu_torch.cli import build
    from freerl_tpu_torch.train.runio import load_checkpoint

    env, algo = build(args)
    generator = torch.Generator(device=algo.device).manual_seed(0)
    state = load_checkpoint(os.path.join(args.model_dir, "checkpoint"),
                            algo.init(generator))

    if hasattr(algo, "init_policy_carry"):
        # GRU policies thread the hidden carry through the rollout; no
        # episode resets inside it
        def act_fn(obs, carry):
            no_reset = torch.zeros(obs.shape[0], dtype=torch.bool,
                                   device=obs.device)
            return algo.evaluate_action(state, obs, carry, no_reset)

        return env, algo, act_fn, algo.init_policy_carry
    if args.algo == "ENVELOPE":
        # preference-conditioned: score at a fixed preference
        rdim = getattr(env, "reward_dim", 2)
        w = (np.asarray(args.preference, dtype=np.float32)
             if args.preference else np.full((rdim,), 1.0 / rdim, np.float32))
        w = torch.as_tensor(w / w.sum(), device=algo.device)
        return env, algo, (lambda obs: algo.evaluate_action(state, obs, w)), \
            None
    return env, algo, (lambda obs: algo.evaluate_action(state, obs)), None


def score(args, policy=None) -> np.ndarray:
    """The run's returns over ``args.n_episodes`` held-out episodes, (E,)
    or (E, A) for a multi-agent algo; ``policy`` is ``load_policy(args)``
    where the caller has it."""
    from freerl_tpu_torch.cli import MARL_OFF, MARL_ON
    from freerl_tpu_torch.train.evaluate import evaluate

    env, _, act_fn, carry_fn = policy or load_policy(args)
    return evaluate(
        env, act_fn, n_episodes=args.n_episodes, seed0=args.seed0,
        multi_agent=args.algo in MARL_OFF | MARL_ON or args.algo == "MAT",
        carry_init=carry_fn(args.n_episodes) if carry_fn else None)


def main(argv=None):
    from freerl_tpu_torch.train.evaluate import plot_evaluate

    args = parse(argv)
    policy = load_policy(args)
    env, _, act_fn, carry_fn = policy
    returns = score(args, policy)
    if returns.ndim > 1:
        mean, std = returns.mean(axis=0), returns.std(axis=0)
        print(f"eval over {args.n_episodes} held-out episodes, per agent:")
        for i, (m, s) in enumerate(zip(mean, std)):
            print(f"  agent_{i}: {m:.2f} +- {s:.2f}")
        curve = returns.mean(axis=-1)
    else:
        print(f"eval over {args.n_episodes} held-out episodes: "
              f"{returns.mean():.2f} +- {returns.std():.2f} "
              f"(threshold: {env.reward_threshold})")
        curve = returns

    png = plot_evaluate(curve, goal=env.reward_threshold,
                        out_path=os.path.join(args.model_dir, "evaluate.png"))
    print(f"plot: {png}")

    if args.gif:
        from freerl_tpu_torch.train.render import render_episode_gif

        gif_seed = (args.gif_seed if args.gif_seed is not None
                    else int(np.random.default_rng().integers(0, 10_000)))
        gif = render_episode_gif(
            env, act_fn, out_path=os.path.join(args.model_dir,
                                               "evaluate.gif"),
            seed=gif_seed, carry_init=carry_fn(1) if carry_fn else None)
        print(f"gif: {gif} (episode seed {gif_seed})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
