"""Where the time goes in the PyTorch port's main path, on one CUDA card.

    python3 scripts/torch_profile.py [--config per|uniform|rainbow]
                                     [--num-envs 1024] [--steps 32]

Builds the DQN LunarLander actor-learner loop of ``train_offpolicy`` at
full width (8-128-4 net, buffer 1e6, batch 256) with PER on the sum-tree
sampler (``per``, the default), uniform replay (``uniform``) or all six
tricks (``rainbow``: double, dueling, PER tree, noisy, 3-step, C51), warms
it up for one chunk, then:

1. times ``--steps`` vector steps as the loop runs them (no sync inside);
2. times each phase of a vector step (explore, env step, replay add,
   episode record, learner step) on the host clock, with a
   ``torch.cuda.synchronize()`` after each phase, over ``--steps`` steps;
3. profiles ``--steps`` vector steps with ``torch.profiler`` and reports
   the device's busy share (kernel time over the profiled wall time, which
   the profiler itself stretches), the kernels per step and the kernels
   that take the most device time.

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

from freerl_tpu_torch.algos import DQN, DQNConfig  # noqa: E402
from freerl_tpu_torch.train import loop  # noqa: E402
from freerl_tpu_torch.envs import make  # noqa: E402

CONFIGS = {
    "per": dict(per=True),
    "uniform": dict(per=False),
    "rainbow": dict(double=True, dueling=True, per=True, noisy=True,
                    n_step=3, categorical=True),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=sorted(CONFIGS), default="per")
    ap.add_argument("--num-envs", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    label = args.config

    env = make("LunarLander-v2", device="cuda")
    algo = DQN(env.dim_info, DQNConfig(per_sampler="tree", **CONFIGS[label]),
               device="cuda")
    cfg = loop.OffPolicyConfig(num_envs=args.num_envs, start_steps=500,
                               chunk_size=64, max_episodes=10**9)
    generator = torch.Generator(device="cuda").manual_seed(0)
    n = args.num_envs
    record_cap = 10**6
    carry = loop.LoopCarry(
        algo_state=algo.init(generator),
        buffer=algo.make_buffer(loop.example_transition(env), num_envs=n),
        env_state=None, obs=None,
        ep_return=torch.zeros(n, device="cuda"),
        done_prev=torch.zeros(n, dtype=torch.bool, device="cuda"),
        ep_counter=torch.zeros((), dtype=torch.int64, device="cuda"),
        episode_returns=torch.zeros(record_cap + 1, device="cuda"),
    )
    carry.env_state, carry.obs = loop.vec_reset(env, generator, n)
    for _ in range(cfg.chunk_size):                       # warm-up chunk
        loop.vector_step(env, algo, cfg, carry, generator, record_cap)
    torch.cuda.synchronize()

    # 1. the loop as it runs
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loop.vector_step(env, algo, cfg, carry, generator, record_cap)
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
            env, carry.env_state, action, generator, n))
        timed("add", lambda: carry.buffer.add(loop.Transition(
            obs=carry.obs, action=action, reward=out.reward,
            next_obs=out.next_obs, done=out.terminated,
            episode_done=out.episode_done)))

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
            loop.vector_step(env, algo, cfg, carry, generator, record_cap)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events, without the spans of user annotations such as
    # "Optimizer.step#Adam.step", which cover kernels counted on their own
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Optimizer.")]
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
