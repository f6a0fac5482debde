"""Where the time goes in the PyTorch port's main path, on one CUDA card.

    python3 scripts/torch_profile.py
        [--config per|uniform|rainbow|ddpg|td3|sac|ppo_bipedal|ppo_cartpole|
                  reinforce|maddpg_spread|matd3_spread|masac_spread|
                  maac_spread|maddpg_worldcomm|mappo_spread|happo_spread|
                  mat_spread|rmappo_spread|gail_pendulum|cem_pendulum|
                  envelope_dst|pixel_dqn]
        [--num-envs 1024] [--steps 32]

Builds the actor-learner loop of ``train_offpolicy`` at full width (buffer
1e6, batch 256): DQN on LunarLander-v2 (8-128-4 net) with PER on the
sum-tree sampler (``per``, the default), uniform replay (``uniform``) or
all six tricks (``rainbow``: double, dueling, PER tree, noisy, 3-step,
C51); or DDPG, TD3 or SAC on LunarLanderContinuous-v2 (the configs'
defaults, 2x128 nets); or the multi-agent loop of ``train_marl`` at the
configs' defaults: MADDPG, MATD3 or MASAC on simple_spread_v3, MAAC on its
discrete form, MADDPG on simple_world_comm_v3. Or the on-policy loop of
``train_onpolicy``: PPO with its defaults (2x128 nets, 10 epochs of
minibatch 64) on BipedalWalker-v3 (``ppo_bipedal``) or CartPole-v1
(``ppo_cartpole``), T 16, or REINFORCE on CartPole-v1 (``reinforce``), T
64; or the multi-agent on-policy family on simple_spread_v3 at the
configs' defaults: MAPPO (stacked), HAPPO, MAT (continuous), T 4, and
rMAPPO, T 10 (one BPTT chunk); ``--steps`` is then ignored, and an
iteration (rollout of T vector steps, then one update) is broken into
the rollout's phases (sample, env step, process: reward and obs hooks,
episode record, rollout write) and the update, with the kernels per
vector step and per Adam step. The off-policy loop
(and the multi-agent one) is warmed up for one chunk, then:

1. times ``--steps`` vector steps as the loop runs them (no sync inside);
2. times each phase of a vector step (explore, env step, replay add,
   episode record, learner step) on the host clock, with a
   ``torch.cuda.synchronize()`` after each phase, over ``--steps`` steps;
3. profiles ``--steps`` vector steps with ``torch.profiler`` and reports
   the device's busy share (kernel time over the profiled wall time, which
   the profiler itself stretches), the kernels per step and the kernels
   that take the most device time.

Slice 6: ``envelope_dst`` (ENVELOPE at its defaults on deep-sea-treasure-v0,
its replay add through ``add_transition``) and ``pixel_dqn`` (DQN with
scripts/pixel_curve.py's small conv trunk on PixelCartPole-v1) run the
off-policy loop above. ``gail_pendulum`` profiles one GAIL iteration
(scripts/gail_e2e.py's learner, 8 envs by default, T = 2048 / envs): the
rollout per vector step, the D step, the PPO update per Adam step, the
whole iteration. ``cem_pendulum`` profiles CEM-GD3PG at its defaults: a
fused 4-lane 200-step episode, a 10 x 200 population evaluation, and
learner steps.

Prints one JSON line at the end; writes the profiler table to
``torch_profile_<config>.txt`` in the git-ignored output directory.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import device_kernels, marl_env, state_adam_steps  # noqa: E402
from freerl_tpu_torch import algos  # noqa: E402
from freerl_tpu_torch.train import loop, marl  # noqa: E402
from freerl_tpu_torch.envs import make  # noqa: E402

# config: (env, algo, config keywords)
CONFIGS = {
    "per": ("LunarLander-v2", "DQN", dict(per=True, per_sampler="tree")),
    "uniform": ("LunarLander-v2", "DQN", dict(per=False)),
    "rainbow": ("LunarLander-v2", "DQN",
                dict(double=True, dueling=True, per=True, per_sampler="tree",
                     noisy=True, n_step=3, categorical=True)),
    "ddpg": ("LunarLanderContinuous-v2", "DDPG", dict(batch_size=256)),
    "td3": ("LunarLanderContinuous-v2", "TD3", dict(batch_size=256)),
    "sac": ("LunarLanderContinuous-v2", "SAC", dict(batch_size=256)),
    # slice 6: ENVELOPE at its defaults (2x256, batch 256, buffer 100k,
    # weight_num 4); pixel DQN with scripts/pixel_curve.py's config
    "envelope_dst": ("deep-sea-treasure-v0", "Envelope", dict()),
    "pixel_dqn": ("PixelCartPole-v1", "DQN",
                  dict(buffer_size=100_000, batch_size=64,
                       obs_shape=(48, 48, 2), conv_arch="small",
                       cnn_features=128)),
}
# slice 6's training loops of their own: GAIL on Pendulum-v1 with
# scripts/gail_e2e.py's learner at 8 envs, CEM-GD3PG on Pendulum-v1 at its
# defaults
OWN = ("gail_pendulum", "cem_pendulum")
# multi-agent config of train_marl, at the configs' defaults (2x128, batch
# 256, replay 1e6): (env, algo, config keywords); MATD3 is MADDPG with twin
MARL = {
    "maddpg_spread": ("simple_spread_v3", "MADDPG", dict()),
    "matd3_spread": ("simple_spread_v3", "MADDPG", dict(twin=True)),
    "masac_spread": ("simple_spread_v3", "MASAC", dict()),
    "maac_spread": ("simple_spread_v3 discrete", "MAAC", dict()),
    "maddpg_worldcomm": ("simple_world_comm_v3", "MADDPG", dict()),
}
# on-policy config: (env, algo, config keywords, T)
ONPOLICY = {
    "ppo_bipedal": ("BipedalWalker-v3", "PPO", dict(), 16),
    "ppo_cartpole": ("CartPole-v1", "PPO", dict(), 16),
    "reinforce": ("CartPole-v1", "REINFORCE", dict(), 64),
    "mappo_spread": ("simple_spread_v3", "MAPPO", dict(), 4),
    "happo_spread": ("simple_spread_v3", "HAPPO", dict(), 4),
    "mat_spread": ("simple_spread_v3", "MAT", dict(), 4),
    "rmappo_spread": ("simple_spread_v3", "RMAPPO", dict(), 10),
}


def profile_onpolicy(label: str, n: int, card: str) -> dict:
    """One on-policy iteration at full width, broken down by phase."""
    from torch.profiler import ProfilerActivity, profile

    from freerl_tpu_torch.train import onpolicy

    env_name, algo_name, kwargs, T = ONPOLICY[label]
    env = make(env_name, device="cuda")
    cfg_cls = getattr(algos, algo_name + "Config")
    if algo_name != "REINFORCE":
        kwargs = dict(kwargs, horizon=n * T, num_envs=n)
    multi = getattr(env, "n_agents", 1) > 1       # the algo takes the env
    algo = getattr(algos, algo_name)(env if multi else env.dim_info,
                                     cfg_cls(**kwargs), device="cuda")
    recurrent = hasattr(algo, "init_policy_carry")
    remap = getattr(env, "action_space_01", False) and env.dim_info.is_continue
    generator = torch.Generator(device="cuda").manual_seed(0)
    record_cap = 10**6
    c = onpolicy.start(env, algo, n, generator, record_cap)

    def rollout():
        for t in range(T):
            onpolicy.vector_step(env, algo, c, generator, record_cap, t, T)

    rollout()                                   # warm-up iteration
    onpolicy.learn(algo, c, generator)
    torch.cuda.synchronize()

    # 1. the rollout and the update as the loop runs them
    t0 = time.perf_counter()
    rollout()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / T
    before = state_adam_steps(c.algo_state)
    t0 = time.perf_counter()
    onpolicy.learn(algo, c, generator)
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) * 1e3
    n_adam = state_adam_steps(c.algo_state) - before

    # 2. synchronized phase times of the rollout's vector steps
    phases = {k: 0.0 for k in ("sample", "env_step", "process")}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        phases[name] += time.perf_counter() - t0
        return out

    def sample(t):
        draws = algo.draw_action(n, generator)
        if not recurrent:
            return algo.sample_action(c.algo_state, c.obs, draws)
        env_a, stored, logp, c.policy_carry, extras = algo.sample_action(
            c.algo_state, c.obs, draws, c.policy_carry, c.done_prev)
        c.extras = onpolicy._write(c.extras, t, T, extras, dict)
        return env_a, stored, logp

    for t in range(T):
        env_a, stored, logp = timed("sample", lambda: sample(t))
        if remap:
            env_a = (env_a + 1.0) / 2.0
        out = timed("env_step", lambda: loop.vec_step_auto_reset(
            env, c.env_state, env_a, generator, n))

        def process():
            c.algo_state, reward = algo.process_reward(
                c.algo_state, out.reward, out.episode_done)
            c.algo_state, next_obs, carry_obs = algo.process_obs(
                c.algo_state, out.next_obs, out.carry_obs)
            loop.record_episodes(env, c, out.reward, out.episode_done,
                                 record_cap)
            c.rollout = onpolicy._write(c.rollout, t, T, dict(
                obs=c.obs, action=stored, log_pi=logp, reward=reward,
                next_obs=next_obs, done=out.terminated,
                adv_done=out.episode_done))
            c.env_state, c.obs = out.state, carry_obs
            if recurrent:
                c.done_prev = out.episode_done
        timed("process", process)
    phase_ms = {k: v * 1e3 / T for k, v in phases.items()}

    # 3. profiler over one rollout, then over one update
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rollout()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    rollout_table = prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=20)
    before = state_adam_steps(c.algo_state)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_u:
        t0 = time.perf_counter()
        onpolicy.learn(algo, c, generator)
        torch.cuda.synchronize()
        update_wall_ms = (time.perf_counter() - t0) * 1e3
    n_adam_prof = state_adam_steps(c.algo_state) - before
    kernels_u = device_kernels(prof_u)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/torch_profile_{label}.txt", "w") as fh:
        fh.write(f"{card}\nrollout of {T} vector steps\n{rollout_table}\n"
                 "update\n" + prof_u.key_averages().table(
                     sort_by="cuda_time_total", row_limit=20) + "\n")
    device_us = sum(e.device_time for e in kernels)
    device_us_u = sum(e.device_time for e in kernels_u)
    return {
        "config": label, "num_envs": n, "T": T, "card": card,
        "vector_step_ms": step_ms,
        "update_ms": update_ms,
        "adam_steps_per_update": n_adam,
        "iteration_ms": step_ms * T + update_ms,
        "env_steps_per_s": n * T / ((step_ms * T + update_ms) / 1e3),
        "vector_step_ms_synced": sum(phase_ms.values()),
        "phase_ms_synced": phase_ms,
        "vector_step_ms_profiled": wall_ms / T,
        "device_busy_share_rollout": device_us / 1e3 / wall_ms,
        "kernels_per_vector_step": len(kernels) / T,
        "update_ms_profiled": update_wall_ms,
        "device_busy_share_update": device_us_u / 1e3 / update_wall_ms,
        "kernels_per_adam_step": len(kernels_u) / max(n_adam_prof, 1),
        "kernels_per_update": len(kernels_u),
    }


def profiled(fn):
    """(ms, kernels, device busy share) of ``fn()`` under torch.profiler,
    synchronized."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    return (wall_ms, len(kernels),
            sum(e.device_time for e in kernels) / 1e3 / wall_ms)


def synced_ms(fn, reps: int = 1) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def profile_gail(n: int, card: str) -> dict:
    """One GAIL iteration (T = 2048 // n vector steps, one D step, the
    relabel, one PPO update), by phase."""
    from freerl_tpu_torch.algos import GAIL, GAILConfig, PPOConfig, Rollout
    from freerl_tpu_torch.algos.gail import (ExpertData, GAILDraws,
                                             gail_iteration)
    from freerl_tpu_torch.envs import step_auto_reset, vec_reset

    env = make("Pendulum-v1", device="cuda")
    gail = GAIL(env.dim_info,
                PPOConfig(horizon=2048, minibatch_size=64, num_envs=n,
                          actor_lr=1e-4, adv_norm=True, orthogonal_init=True),
                GAILConfig(d_steps_per_iter=1, d_lr=1e-4), device="cuda")
    T = 2048 // n
    g = torch.Generator(device="cuda").manual_seed(0)
    expert = ExpertData(torch.randn(8192, 3, device="cuda"),
                        torch.rand(8192, 1, device="cuda") * 4 - 2)
    draws = GAILDraws(g)
    state = gail.init(g)
    env_state, obs = vec_reset(env, g, n)

    def iteration():
        nonlocal state, env_state, obs
        state, env_state, obs, _ = gail_iteration(
            gail, env, expert, state, env_state, obs,
            draws.iteration(gail, env, n, T, 8192))

    iteration()                                   # warm-up
    it_ms = synced_ms(iteration)
    d = draws.iteration(gail, env, n, T, 8192)

    def rollout():
        nonlocal env_state, obs
        for t in range(T):
            a, _, _ = gail.ppo.sample_action(state.ppo_state, obs,
                                             d.action[t])
            out = step_auto_reset(env, env_state, a, d.step[t], d.reset[t])
            env_state, obs = out.state, out.carry_obs

    s, a = expert.sample(g, 256)
    roll = Rollout(obs=torch.randn(T, n, 3, device="cuda"),
                   action=torch.randn(T, n, 1, device="cuda"),
                   log_pi=torch.randn(T, n, device="cuda"),
                   reward=torch.randn(T, n, device="cuda"),
                   next_obs=torch.randn(T, n, 3, device="cuda"),
                   done=torch.zeros(T, n, dtype=torch.bool, device="cuda"),
                   adv_done=torch.zeros(T, n, dtype=torch.bool,
                                        device="cuda"))
    rollout_ms, rollout_k, rollout_busy = profiled(rollout)
    d_ms, d_k, _ = profiled(lambda: gail.train_d(state, s, a, s, a))
    before = state_adam_steps(state.ppo_state)
    u_ms, u_k, u_busy = profiled(lambda: gail.ppo.update(
        state.ppo_state, roll, gail.ppo.draw_update(roll, g)))
    adam = state_adam_steps(state.ppo_state) - before
    it_prof_ms, it_k, it_busy = profiled(iteration)
    return {
        "config": "gail_pendulum", "num_envs": n, "T": T, "card": card,
        "iteration_ms": it_ms,
        "env_steps_per_s": n * T / (it_ms / 1e3),
        "vector_step_ms_profiled": rollout_ms / T,
        "kernels_per_vector_step": rollout_k / T,
        "device_busy_share_rollout": rollout_busy,
        "d_step_ms_profiled": d_ms, "kernels_per_d_step": d_k,
        "iteration_ms_profiled": it_prof_ms, "kernels_per_iteration": it_k,
        "device_busy_share_iteration": it_busy,
        "update_ms_profiled": u_ms, "update_adam_steps": adam,
        "update_kernels_per_adam_step": u_k / max(adam, 1),
        "device_busy_share_update": u_busy,
    }


def profile_cem(card: str) -> dict:
    """CEM-GD3PG at its defaults on Pendulum-v1: a fused 4-lane episode
    (200 steps), a population evaluation (10 x 200) and learner steps,
    each by itself."""
    from freerl_tpu_torch.algos import CEMGD3PG, CEMDraws
    from freerl_tpu_torch.buffers import ReplayBuffer
    from freerl_tpu_torch.core.types import Transition

    env = make("Pendulum-v1", device="cuda")
    algo = CEMGD3PG(env.dim_info, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    draws = CEMDraws(g)
    state = algo.init(g)
    flat4 = torch.stack([algo.flat(state.actor1),
                         algo.flat(state.actor2)]).repeat(2, 1)
    sig4 = torch.tensor([0.0, 0.0, 0.1, 0.1], device="cuda")
    pop = algo.get_params(state.actor1)[None].repeat(10, 0)

    def episode():
        algo.rollout(env, flat4, draws.chunk(env, True, 200), sig4)

    def population():
        algo.eval_population(env, pop, draws.population(env, 10, 200))

    _, trans = algo.eval_population(env, pop, draws.population(env, 10,
                                                               200))
    buf = ReplayBuffer.create(200_000, trans.map(lambda x: x[0, 0]))
    buf.add(trans.map(lambda x: x.reshape((-1,) + tuple(x.shape[2:]))))

    def learn(k):
        algo.learn_burst(state, buf, buf, draws.burst(k, 32, buf.size,
                                                      buf.size),
                         True, 0.5)

    episode()
    learn(2)                                        # warm-up
    ep_ms, ep_k, ep_busy = profiled(episode)
    pop_ms, pop_k, _ = profiled(population)
    learn_ms = synced_ms(lambda: learn(100)) / 100
    l_ms, l_k, l_busy = profiled(lambda: learn(10))
    return {
        "config": "cem_pendulum", "card": card,
        "fused_vector_step_ms_profiled": ep_ms / 200,
        "fused_kernels_per_vector_step": ep_k / 200,
        "device_busy_share_fused": ep_busy,
        "population_vector_step_ms_profiled": pop_ms / 200,
        "population_kernels_per_vector_step": pop_k / 200,
        "learner_step_ms": learn_ms,
        "learner_step_ms_profiled": l_ms / 10,
        "kernels_per_learner_step": l_k / 10,
        "device_busy_share_learn": l_busy,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=sorted(CONFIGS) + sorted(ONPOLICY)
                    + sorted(MARL) + sorted(OWN), default="per")
    ap.add_argument("--num-envs", type=int, default=None,
                    help="1024 (gail_pendulum: 8)")
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile: needs a CUDA card", file=sys.stderr)
        return 1
    # float32 throughout, as chip_smoke.py runs the port (torch's cuDNN
    # default would run the conv trunks in TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    label = args.config
    n = args.num_envs or (8 if label == "gail_pendulum" else 1024)
    if label in ONPOLICY:
        print(json.dumps(profile_onpolicy(label, n, card)))
        return 0
    if label in OWN:
        print(json.dumps(profile_gail(n, card) if label == "gail_pendulum"
                         else profile_cem(card)))
        return 0

    record_cap = 10**6
    generator = torch.Generator(device="cuda").manual_seed(0)
    if label in MARL:
        env_name, algo_name, kwargs = MARL[label]
        env = marl_env(env_name, "cuda")
        algo = getattr(algos, algo_name)(
            env, getattr(algos, algo_name + "Config")(**kwargs),
            device="cuda")
        driver = marl
        cfg = marl.MARLConfig(num_envs=n, start_steps=500, chunk_size=64)
        carry = marl.start(env, algo, n, generator, record_cap)
    else:
        env_name, algo_name, kwargs = CONFIGS[label]
        env = make(env_name, device="cuda")
        cfg_cls = getattr(algos, algo_name + "Config")
        if "num_envs" in cfg_cls.__dataclass_fields__:
            kwargs = dict(kwargs, num_envs=n)
        # a multi-objective env's algo takes its reward width
        extra = (env.reward_dim,) if hasattr(env, "reward_dim") else ()
        algo = getattr(algos, algo_name)(env.dim_info, *extra,
                                         cfg_cls(**kwargs), device="cuda")
        driver = loop
        cfg = loop.OffPolicyConfig(num_envs=n, start_steps=500,
                                   chunk_size=64, max_episodes=10**9)
        carry = loop.LoopCarry(
            algo_state=algo.init(generator),
            buffer=algo.make_buffer(loop.example_transition(env, algo),
                                    num_envs=n),
            env_state=None, obs=None,
            ep_return=torch.zeros(n, device="cuda"),
            done_prev=torch.zeros(n, dtype=torch.bool, device="cuda"),
            ep_counter=torch.zeros((), dtype=torch.int64, device="cuda"),
            episode_returns=torch.zeros(record_cap + 1, device="cuda"),
        )
        carry.env_state, carry.obs = loop.vec_reset(env, generator, n)
    # the multi-agent driver maps stored [-1, 1] actions to the MPE box
    remap = label in MARL and env.dim_info.is_continue
    for _ in range(cfg.chunk_size):                       # warm-up chunk
        driver.vector_step(env, algo, cfg, carry, generator, record_cap)
    torch.cuda.synchronize()

    # 1. the loop as it runs
    t0 = time.perf_counter()
    for _ in range(args.steps):
        driver.vector_step(env, algo, cfg, carry, generator, record_cap)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    # 2. synchronized phase times
    phases = {k: 0.0 for k in ("explore", "env_step", "add", "record",
                               "learn")}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        phases[name] += time.perf_counter() - t0
        return out

    ctx = loop.ExploreCtx(total_env_steps=10**9, episodes=carry.ep_counter,
                          done_prev=carry.done_prev)
    t_all = time.perf_counter()
    for _ in range(args.steps):
        _, action = timed("explore", lambda: algo.explore(
            carry.algo_state, carry.obs, generator, ctx))
        out = timed("env_step", lambda: loop.vec_step_auto_reset(
            env, carry.env_state, (action + 1.0) / 2.0 if remap else action,
            generator, n))
        trans = loop.Transition(
            obs=carry.obs, action=action, reward=out.reward,
            next_obs=out.next_obs, done=out.terminated,
            episode_done=out.episode_done)
        if hasattr(algo, "add_transition"):
            timed("add", lambda: algo.add_transition(
                carry.algo_state, carry.buffer, trans, generator))
        else:
            timed("add", lambda: carry.buffer.add(trans))

        timed("record", lambda: loop.record_episodes(
            env, carry, out.reward, out.episode_done, record_cap))
        timed("learn", lambda: algo.learn_step(carry.algo_state, carry.buffer,
                                               generator, n))
        carry.env_state, carry.obs = out.state, out.carry_obs
    synced_ms = (time.perf_counter() - t_all) * 1e3 / args.steps
    phase_ms = {k: v * 1e3 / args.steps for k, v in phases.items()}

    # 3. profiler over unsynchronized steps
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            driver.vector_step(env, algo, cfg, carry, generator, record_cap)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    device_us = sum(e.device_time for e in kernels)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/torch_profile_{label}.txt", "w") as fh:
        fh.write(f"{card}\n{table}\n")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    result = {
        "config": label, "num_envs": n, "steps": args.steps, "card": card,
        "step_ms": step_ms,
        "env_steps_per_s": n / (step_ms / 1e3),
        "step_ms_profiled": wall_ms / args.steps,
        "step_ms_synced": synced_ms,
        "phase_ms_synced": phase_ms,
        "device_busy_share": device_us / 1e3 / wall_ms,
        "kernels_per_step": len(kernels) / args.steps,
        "top_kernels_us_per_step": {k[:80]: v / args.steps for k, v in top},
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
