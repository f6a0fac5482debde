"""Training CLI (counterpart: ``freerl_tpu/cli.py``).

Every reference algorithm file ends in an argparse block with the same
vocabulary: --env_name, --seed, --max_episodes, --trick flags,
buffer/batch sizes. This CLI builds the env and the algorithm from flags,
runs the right driver, and writes the reference's artifact set: an
auto-numbered, trick-named run dir, TensorBoard scalars (where tensorboard
is installed), the <Policy>_seed_<s>.npy curve, ``config.json`` and a
full-state ``checkpoint``.

Everything runs on ``--device`` (default ``cuda``; ``--device cpu`` runs
on the CPU), which ``config.json`` records.

Examples:
  python -m freerl_tpu_torch.cli --algo DQN --env_name LunarLander-v2 \
      --trick Double Dueling --max_episodes 500 --seed 0
  python -m freerl_tpu_torch.cli --algo PPO --env_name Pendulum-v1 \
      --trick adv_norm ObsNorm tanh --num_envs 16
  python -m freerl_tpu_torch.cli --algo MAPPO --env_name simple_spread_v3 \
      --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

# trick-name -> config-field maps (preserving the reference's dict keys)
_DQN_TRICKS = {
    "Double": "double", "Dueling": "dueling", "PER": "per",
    "Noisy": "noisy", "N_Step": "n_step", "Categorical": "categorical",
}
_PPO_TRICKS = {
    "adv_norm": "adv_norm", "ObsNorm": "obs_norm",
    "reward_norm": "reward_norm", "reward_scaling": "reward_scaling",
    "lr_decay": "lr_decay", "orthogonal_init": "orthogonal_init",
    "adam_eps": "adam_eps", "tanh": "tanh", "Beta": "beta_dist",
}
_MAPPO_TRICKS = {
    "adv_norm": "adv_norm", "ObsNorm": "obs_norm",
    "reward_norm": "reward_norm", "reward_scaling": "reward_scaling",
    "orthogonal_init": "orthogonal_init", "adam_eps": "adam_eps",
    "lr_decay": "lr_decay", "ValueClip": "value_clip",
    "huber_loss": "huber_loss", "LayerNorm": "layer_norm",
    "feature_norm": "feature_norm", "attention": "attention",
}
_DDPG_SUPPLEMENTS = {
    "weight_decay": "weight_decay", "OUNoise": "ou_noise",
    "ObsNorm": "obs_norm", "net_init": "net_init", "PopArt": "popart",
    "gumbel": "discrete_gumbel",
}
# the recurrent variants take the trick subset that composes with BPTT
_RMAPPO_TRICKS = {
    "adv_norm": "adv_norm", "ObsNorm": "obs_norm",
    "reward_norm": "reward_norm", "reward_scaling": "reward_scaling",
    "orthogonal_init": "orthogonal_init", "adam_eps": "adam_eps",
    "lr_decay": "lr_decay", "ValueClip": "value_clip",
    "huber_loss": "huber_loss", "LayerNorm": "layer_norm",
}

OFFPOLICY = {"DQN", "DDPG", "TD3", "SAC", "ENVELOPE"}
ONPOLICY = {"PPO", "REINFORCE", "MAT"}
MARL_OFF = {"MADDPG", "MATD3", "MASAC", "MAAC"}
MARL_ON = {"MAPPO", "HAPPO", "IPPO", "RMAPPO", "RIPPO"}


def _apply_tricks(cfg, tricks, table, algo):
    fields = {}
    for t in tricks:
        if t not in table:
            raise SystemExit(
                f"unknown trick {t!r} for {algo}; valid: {sorted(table)}")
        field = table[t]
        fields[field] = 3 if field == "n_step" else True
    return dataclasses.replace(cfg, **fields)


def build_env(args):
    """The env of the flags on ``args.device``, with its ``--fixed_reset``
    wrapper."""
    from freerl_tpu_torch.envs import make

    device = getattr(args, "device", "cuda")
    env_kwargs = {}
    if args.algo == "MAAC" or (
            (args.algo in MARL_ON or args.algo == "MAT")
            and args.discrete_actions):
        env_kwargs["continuous_actions"] = False
    if getattr(args, "N", None):
        # the reference's env_agent_n knob: N for spread / adversary,
        # num_good for tag / world comm
        if args.env_name in ("simple_tag_v3", "simple_world_comm_v3"):
            env_kwargs["num_good"] = args.N
        else:
            env_kwargs["N"] = args.N
    if args.env_name == "fake-smac" or args.env_name.startswith("smac:"):
        # the SMAC-protocol route: 'fake-smac' is the instrumented protocol
        # toy, 'smac:<module>:<fn>' a real SMACv2 constructor on a machine
        # that has the binary; --use_state feeds env.get_state() to the
        # centralized critic
        from freerl_tpu_torch.envs.smac import FakeSmacEnv, HostSmacVecEnv

        if args.env_name == "fake-smac":
            make_fn = FakeSmacEnv
        else:
            import importlib

            modpath, fn = args.env_name[5:].rsplit(":", 1)
            make_fn = getattr(importlib.import_module(modpath), fn)
        env = HostSmacVecEnv(make_fn, num_envs=args.num_envs,
                             use_state=getattr(args, "use_state", False),
                             device=device)
    else:
        env = make(args.env_name, dis_to_con=args.dis_to_con, device=device,
                   **env_kwargs)
    # getattr: config.json files from runs predating a flag (and test
    # namespaces) lack its key
    if getattr(args, "fixed_reset", False):
        # the reference's same-seed-every-episode reset convention;
        # --reset_seed pins the layout apart from the training seed
        from freerl_tpu_torch.envs.base import FixedResetWrapper

        rs = getattr(args, "reset_seed", None)
        env = FixedResetWrapper(env, seed=args.seed if rs is None else rs)
    return env


def build(args):
    """(env, algo) from the flags, both on ``args.device``."""
    from freerl_tpu_torch import algos

    device = getattr(args, "device", "cuda")
    env = build_env(args)
    dev = dict(device=device)
    a, n_envs = args.algo, args.num_envs
    if a == "DQN":
        cfg = _apply_tricks(
            algos.DQNConfig(buffer_size=args.buffer_size,
                            batch_size=args.batch_size),
            args.trick, _DQN_TRICKS, a)
        return env, algos.DQN(env.dim_info, cfg, **dev)
    if a == "DDPG":
        cfg = _apply_tricks(
            algos.DDPGConfig(buffer_size=args.buffer_size,
                             batch_size=args.batch_size, num_envs=n_envs,
                             gauss_sigma=args.gauss_sigma,
                             noise_init_scale=args.noise_init_scale),
            args.trick, _DDPG_SUPPLEMENTS, a)
        return env, algos.DDPG(env.dim_info, cfg, **dev)
    if a == "TD3":
        return env, algos.TD3(env.dim_info, algos.TD3Config(
            buffer_size=args.buffer_size, batch_size=args.batch_size,
            num_envs=n_envs), **dev)
    if a == "SAC":
        return env, algos.SAC(env.dim_info, algos.SACConfig(
            buffer_size=args.buffer_size, batch_size=args.batch_size,
            num_envs=n_envs), **dev)
    if a == "ENVELOPE":
        # full float32 for the preference-conditioned Q, as the JAX CLI:
        # reduced-precision matmul noise feeds the max-bias inflation loop
        # at extreme preferences. torch's defaults already run float32
        # matmuls in full, but cuDNN convolutions in TF32, and a caller may
        # have turned TF32 on. Process-global; an explicit
        # FREERL_MATMUL_PRECISION (read at import) wins.
        if not os.environ.get("FREERL_MATMUL_PRECISION"):
            from freerl_tpu_torch import set_matmul_precision

            set_matmul_precision("float32")
        rdim = getattr(env, "reward_dim", 2)
        return env, algos.Envelope(env.dim_info, rdim, algos.EnvelopeConfig(
            buffer_size=args.buffer_size, batch_size=args.batch_size,
            max_episodes=args.max_episodes,
            # the reference's protocol knobs; the library defaults stay
            # small for the tests
            weight_num=128, epsilon=0.4, epsilon_decay=True), **dev)
    if a == "PPO":
        cfg = _apply_tricks(
            algos.PPOConfig(num_envs=n_envs, horizon=args.horizon),
            args.trick, _PPO_TRICKS, a)
        return env, algos.PPO(env.dim_info, cfg, **dev)
    if a == "REINFORCE":
        return env, algos.REINFORCE(env.dim_info, algos.REINFORCEConfig(
            lr=args.lr), **dev)
    if a == "MAT":
        return env, algos.MAT(env, algos.MATConfig(
            num_envs=n_envs, horizon=args.horizon), **dev)
    # optional lr overrides (the reference's --actor_lr / --critic_lr)
    lr_kw = {}
    if getattr(args, "actor_lr", None) is not None:
        lr_kw["actor_lr"] = args.actor_lr
    if getattr(args, "critic_lr", None) is not None:
        lr_kw["critic_lr"] = args.critic_lr
    if a in {"MADDPG", "MATD3"}:
        cfg = algos.MADDPGConfig(buffer_size=args.buffer_size,
                                 batch_size=args.batch_size,
                                 num_envs=n_envs,
                                 att_critic="ATT" in args.trick, **lr_kw)
        ctor = algos.MATD3 if a == "MATD3" else algos.MADDPG
        return env, ctor(env, cfg, **dev)
    if a == "MASAC":
        return env, algos.MASAC(env, algos.MASACConfig(
            buffer_size=args.buffer_size, batch_size=args.batch_size,
            num_envs=n_envs, **lr_kw), **dev)
    if a == "MAAC":
        return env, algos.MAAC(env, algos.MAACConfig(
            buffer_size=args.buffer_size, batch_size=args.batch_size,
            num_envs=n_envs, **lr_kw), **dev)
    if a in MARL_ON:
        mask_kw = {}
        if hasattr(env, "n_actions") and hasattr(env, "use_state"):
            # SMAC-protocol env: the mask rides the obs tail, the state
            # (under use_state) sits between the raw obs and the mask
            mask_kw = dict(masked=True, mask_dim=env.n_actions,
                           state_dim=getattr(env, "state_dim", 0))
        if a in ("RMAPPO", "RIPPO"):
            if mask_kw.pop("state_dim", 0):
                raise SystemExit(
                    "--use_state is a centralized-MAPPO capability; the "
                    "recurrent variants support masking but not the "
                    "state-augmented critic")
            rcfg = _apply_tricks(
                algos.RMAPPOConfig(num_envs=n_envs, horizon=args.horizon,
                                   **mask_kw),
                args.trick, _RMAPPO_TRICKS, a)
            ctor = algos.RIPPO if a == "RIPPO" else algos.RMAPPO
            return env, ctor(env, rcfg, **dev)
        cfg = _apply_tricks(
            algos.MAPPOConfig(num_envs=n_envs, horizon=args.horizon,
                              **mask_kw),
            args.trick, _MAPPO_TRICKS, a)
        if a == "IPPO":
            return env, algos.IPPO(env, cfg, **dev)
        if a == "HAPPO":
            return env, algos.HAPPO(
                env, algos.HAPPOConfig(**dataclasses.asdict(cfg)), **dev)
        return env, algos.MAPPO(env, cfg, **dev)
    raise SystemExit(f"unknown algo {a!r}")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--algo", default="DQN")
    p.add_argument("--env_name", default="CartPole-v1")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_episodes", type=int, default=500)
    p.add_argument("--num_envs", type=int, default=8)
    p.add_argument("--start_steps", type=int, default=500)
    p.add_argument("--random_steps", type=int, default=0)
    p.add_argument("--updates_per_burst", type=int, default=1)
    p.add_argument("--horizon", type=int, default=2048)
    p.add_argument("--buffer_size", type=int, default=200_000)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--trick", nargs="*", default=[])
    p.add_argument("--dis_to_con", action="store_true")
    p.add_argument("--fixed_reset", action="store_true",
                   help="pin every episode reset to one start state "
                        "(the reference's env.reset(seed=seed) loop)")
    p.add_argument("--reset_seed", type=int, default=None,
                   help="with --fixed_reset: pin the layout to THIS seed "
                        "while --seed varies the training rng")
    p.add_argument("--discrete_actions", action="store_true")
    p.add_argument("--actor_lr", type=float, default=None,
                   help="override the algorithm config's actor_lr "
                        "(MARL algos; None = converged default)")
    p.add_argument("--critic_lr", type=float, default=None,
                   help="override the algorithm config's critic_lr")
    p.add_argument("--N", type=int, default=None,
                   help="MPE agent count (reference env_agent_n: N for "
                        "spread/adversary, num_good for tag/world_comm); "
                        "default = env default")
    p.add_argument("--use_state", action="store_true",
                   help="SMAC-protocol envs: feed env.get_state() to the "
                        "centralized critic")
    p.add_argument("--results_root", default="results")
    p.add_argument("--no_tensorboard", action="store_true")
    p.add_argument("--lr", type=float, default=1e-3,
                   help="REINFORCE policy lr (reference policy_net_lr)")
    p.add_argument("--gauss_sigma", type=float, default=0.1,
                   help="DDPG exploration noise std (reference "
                        "gauss_sigma)")
    p.add_argument("--noise_init_scale", type=float, default=None,
                   help="if set, linear per-episode noise-scale decay from "
                        "this value (reference gauss_init_scale)")
    p.add_argument("--save_freq", type=int, default=0,
                   help="checkpoint every N episodes mid-run (reference "
                        "save_freq); 0 = only at the end")
    p.add_argument("--device", default="cuda",
                   help="torch device for the env and the algorithm "
                        "(cuda, or cpu)")
    return p


def run(argv=None):
    """Build and train from CLI flags; returns the run's model_dir."""
    args = parser().parse_args(argv)

    from freerl_tpu_torch.ops import sumtree
    from freerl_tpu_torch.train import (MARLConfig, MetricsWriter,
                                        OffPolicyConfig, OnPolicyConfig,
                                        make_dir, save_checkpoint,
                                        train_marl, train_offpolicy,
                                        train_onpolicy)

    env, algo = build(args)
    trick_dict = {t: True for t in args.trick}
    model_dir = make_dir(args.results_root, args.env_name, args.algo,
                         trick_dict)
    print(f"model_dir: {model_dir}")
    # every flag, so eval.py rebuilds the env and the algorithm from the
    # run dir alone
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(vars(args), f, indent=2, sort_keys=True)
    writer = MetricsWriter(model_dir, args.algo, args.seed,
                           use_tensorboard=not args.no_tensorboard)

    # mid-run checkpoints: the drivers call back per logged chunk with the
    # live carry; save when an episode multiple is crossed
    last_saved = [0]

    def _maybe_save(n_eps, carry):
        if args.save_freq and n_eps // args.save_freq > last_saved[0]:
            last_saved[0] = n_eps // args.save_freq
            save_checkpoint(f"{model_dir}/checkpoint", carry.algo_state)
            print(f"checkpoint @ episode {n_eps}")

    def on_chunk(chunk_i, n_eps, n_steps, carry):
        _maybe_save(n_eps, carry)

    def on_iter(it, n_eps, n_steps, carry, metrics):
        _maybe_save(n_eps, carry)

    # --save_freq wants episode-granular checks: per-chunk logging AND
    # per-chunk episode-count reads (the drivers otherwise read the count
    # lazily and the callback would see stale counts)
    cadence = ({"log_every_chunks": 1, "host_sync_every": 1}
               if args.save_freq else {})

    # the sum-tree kernel's launches in this run alone (the count is global)
    sumtree.launches = 0
    if args.algo in OFFPOLICY:
        cfg = OffPolicyConfig(
            seed=args.seed, num_envs=args.num_envs,
            max_episodes=args.max_episodes, start_steps=args.start_steps,
            random_steps=args.random_steps,
            updates_per_burst=args.updates_per_burst, **cadence)
        state, returns, info = train_offpolicy(env, algo, cfg,
                                               on_chunk=on_chunk)
    elif args.algo in MARL_OFF:
        cfg = MARLConfig(
            seed=args.seed, num_envs=args.num_envs,
            max_episodes=args.max_episodes, start_steps=args.start_steps,
            updates_per_burst=args.updates_per_burst, **cadence)
        state, returns, info = train_marl(env, algo, cfg, on_chunk=on_chunk)
    else:
        cfg = OnPolicyConfig(
            seed=args.seed, num_envs=args.num_envs,
            max_episodes=args.max_episodes, horizon=args.horizon,
            **({"log_every_iters": 1, "host_sync_every": 1}
               if args.save_freq else {}))
        state, returns, info = train_onpolicy(env, algo, cfg,
                                              on_iter=on_iter)
    b1_launches = sumtree.launches

    writer.log_episodes(returns)
    curve_path = writer.save_curve(returns)
    ckpt_path = save_checkpoint(f"{model_dir}/checkpoint", state)
    writer.close()
    print(f"episodes: {info['episodes']}  env_steps: {info['env_steps']}  "
          f"steps/s: {info['env_steps_per_s']:.0f}")
    print(f"final-50 mean return: {float(np.mean(returns[-50:])):.2f}")
    print(f"sumtree_descend launches: {b1_launches}")
    print(f"curve: {curve_path}\ncheckpoint: {ckpt_path}")
    return model_dir


def main(argv=None):
    """Console entry point: exit code 0 on success. :func:`run` returns
    the run directory."""
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
