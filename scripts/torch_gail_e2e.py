"""GAIL end to end in the port (counterpart: ``scripts/gail_e2e.py``): a PPO
expert on Pendulum-v1, its deterministic rollouts as the expert set, GAIL
from scratch on the discriminator's rewards only, and a held-out
evaluation of both, on the card.

    python3 scripts/torch_gail_e2e.py [--expert_episodes 3000]
        [--gail_iters 800] [--n_expert_transitions 20000] [--seed 0]
        [--out results/torch/gail] [--device cuda|cpu]

The four stages of the JAX script (its lines 64-143), with its arguments
and defaults (``golden.GAIL_RUNS``), each through the port's public names:

1. the expert: ``PPO`` with ``expert_configs`` (horizon 400, minibatch 64,
   8 envs, lr 3e-4 decaying over the expert's episodes, observation
   normalization, reward scaling, orthogonal init), trained by
   ``train_onpolicy`` for ``--expert_episodes`` episodes;
2. its 10-episode evaluation from seed 1000 (``evaluate``: the JAX
   script's ten held-out episodes, the same starts) and
   ``--n_expert_transitions`` expert pairs (``collect_expert_data``), both
   from ``PPO.evaluate_action`` on raw observations. The expert set keeps
   the port's generator: it is compared with the JAX script's by its
   statistics, not episode by episode;
3. GAIL with ``gail_configs`` (PPO at horizon 2048, lr 1e-4; one D step an
   iteration at d_lr 1e-4), trained by ``train_gail`` for
   ``--gail_iters`` iterations from seed ``--seed + 1``;
4. the GAIL policy's evaluation, on the same ten episodes.

The run dir, ``<out>/Pendulum-v1/GAIL/<stamp>/`` (``init_logging``), holds
the JAX script's artifact set with its keys: ``config.json``,
``expert_curve.npy``, ``expert_data.npz``, ``gail_true_reward_curve.npy``,
``eval_rewards.npz`` and ``summary.json``; beside them ``run.json`` records
the device, the card, each stage's seconds and the sum-tree kernel's (B1's)
launches, 0 on these paths. The default ``--out`` is the tree that
``golden.check_scalar`` reads for ``SCALAR_GATES``' ``GAIL_Pendulum_eval``
(``results/torch/gail``), never the JAX package's ``results/gail``. It runs
on the card unless ``--device cpu`` asks; without a card it exits
non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from freerl_tpu_torch.train import golden  # noqa: E402

TAG = "GAIL_Pendulum_eval"
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.normpath(
    golden.OURS_ROOT)), "gail")


def expert_configs(expert_episodes: int, seed: int):
    """The JAX script's expert ``PPOConfig`` and ``OnPolicyConfig``. The
    JAX script also sets ``critic_lr=3e-4``, a field its PPO never reads
    (one optimizer at ``actor_lr``), which the port's config leaves out."""
    from freerl_tpu_torch.algos import PPOConfig
    from freerl_tpu_torch.train import OnPolicyConfig

    return (PPOConfig(horizon=400, minibatch_size=64, num_envs=8,
                      adv_norm=True, actor_lr=3e-4, obs_norm=True,
                      reward_scaling=True, orthogonal_init=True, tanh=False,
                      lr_decay=True, lr_decay_episodes=expert_episodes),
            OnPolicyConfig(seed=seed, num_envs=8,
                           max_episodes=expert_episodes, horizon=400))


def gail_configs():
    """The JAX script's GAIL learner: its ``PPOConfig`` and
    ``GAILConfig``."""
    from freerl_tpu_torch.algos import GAILConfig, PPOConfig

    return (PPOConfig(horizon=2048, minibatch_size=64, num_envs=8,
                      actor_lr=1e-4, adv_norm=True, orthogonal_init=True,
                      tanh=False),
            GAILConfig(d_steps_per_iter=1, d_lr=1e-4))


def run(expert_episodes: int, gail_iters: int, n_expert_transitions: int,
        seed: int, out: str, device: str = "cuda", log=print) -> dict:
    """The four stages into a new run dir under ``out``; returns the
    summary, the run dir, each stage's seconds, the sum-tree launches, the
    expert's and GAIL's loop infos and the expert's greedy policy on the
    env's device (``expert_act``)."""
    from freerl_tpu_torch.algos import (GAIL, PPO, collect_expert_data,
                                        init_logging, train_gail)
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.ops import sumtree
    from freerl_tpu_torch.train import evaluate, train_onpolicy

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    env = make("Pendulum-v1", device=device)
    run_dir = init_logging(os.path.join(out, "Pendulum-v1", "GAIL"), dict(
        cpu=device == "cpu", expert_episodes=expert_episodes,
        gail_iters=gail_iters, n_expert_transitions=n_expert_transitions,
        seed=seed, out=out, device=device))
    log(f"run_dir: {run_dir}")
    seconds = {}
    sync()
    sumtree.launches = 0

    # ---- 1. expert
    t0 = time.time()
    expert_cfg, ocfg = expert_configs(expert_episodes, seed)
    expert = PPO(env.dim_info, expert_cfg, device=device)
    expert_state, expert_curve, expert_info = train_onpolicy(env, expert,
                                                             ocfg)
    np.save(os.path.join(run_dir, "expert_curve.npy"), expert_curve)
    sync()
    seconds["expert"] = time.time() - t0
    log(f"expert final-50: {expert_curve[-50:].mean()}")

    # ---- 2. the expert's evaluation and data
    t0 = time.time()
    expert_act = lambda obs: expert.evaluate_action(  # noqa: E731
        expert_state, obs)
    expert_eval = evaluate(env, expert_act, n_episodes=10, seed0=1000)
    log(f"expert 10-seed eval: {expert_eval.mean()}")
    data = collect_expert_data(
        env, expert_act, n_expert_transitions, seed=seed,
        out_path=os.path.join(run_dir, "expert_data.npz"))
    sync()
    seconds["expert_data"] = time.time() - t0

    # ---- 3. GAIL from scratch
    t0 = time.time()
    ppo_cfg, gail_cfg = gail_configs()
    gail = GAIL(env.dim_info, ppo_cfg, gail_cfg, device=device)
    state, curve, history = train_gail(env, gail, data,
                                       num_iterations=gail_iters,
                                       num_envs=8, seed=seed + 1)
    np.save(os.path.join(run_dir, "gail_true_reward_curve.npy"), curve)
    sync()
    seconds["gail"] = time.time() - t0

    # ---- 4. held-out evaluation
    t0 = time.time()
    gail_act = lambda obs: gail.ppo.evaluate_action(  # noqa: E731
        state.ppo_state, obs)
    gail_eval = evaluate(env, gail_act, n_episodes=10, seed0=1000)
    np.savez(os.path.join(run_dir, "eval_rewards.npz"),
             episode_rewards=gail_eval,
             episode_avg_rewards=np.float32(gail_eval.mean()),
             expert_rewards=expert_eval,
             expert_avg_rewards=np.float32(expert_eval.mean()))
    summary = {
        "expert_eval_avg": float(expert_eval.mean()),
        "gail_eval_avg": float(gail_eval.mean()),
        "reference_best_gail_avg": -184.1,
        "reference_other_gail_avg": -642.8,
    }
    with open(os.path.join(run_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    sync()
    seconds["eval"] = time.time() - t0
    log(json.dumps(summary))
    return dict(summary=summary, run_dir=run_dir, seconds=seconds,
                launches=sumtree.launches, expert_info=expert_info,
                expert_act=expert_act,
                gail_iterations=len(curve), history=history)


def main(argv=None) -> int:
    defaults = golden.GAIL_RUNS[TAG]
    ap = argparse.ArgumentParser()
    ap.add_argument("--expert_episodes", type=int,
                    default=defaults["expert_episodes"])
    ap.add_argument("--gail_iters", type=int, default=defaults["gail_iters"])
    ap.add_argument("--n_expert_transitions", type=int,
                    default=defaults["n_expert_transitions"])
    ap.add_argument("--seed", type=int, default=defaults["seed"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_gail_e2e: no CUDA card; pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        return 1
    card = None
    if args.device == "cuda":
        from chip_smoke import card_line
        card = card_line()
    t0 = time.time()
    r = run(args.expert_episodes, args.gail_iters, args.n_expert_transitions,
            args.seed, args.out, args.device,
            log=lambda msg: print(msg, flush=True))
    rec = dict(device=args.device, card=card,
               seconds={k: round(v, 1) for k, v in r["seconds"].items()},
               total_s=round(time.time() - t0, 1),
               b1_launches=r["launches"],
               expert_episodes=int(r["expert_info"]["episodes"]),
               expert_iterations=int(r["expert_info"]["iterations"]),
               gail_iterations=r["gail_iterations"])
    with open(os.path.join(r["run_dir"], "run.json"), "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps(dict(run_dir=os.path.relpath(r["run_dir"], ROOT),
                          **r["summary"], **rec)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
