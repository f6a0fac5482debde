"""Headline benchmark of the port: DQN on LunarLander-v2, aggregate
env-steps/s on one CUDA card (counterpart: the JAX package's root
``bench.py``).

    python -m freerl_tpu_torch.bench

Runs the full actor-learner hot path: the batched LunarLander physics,
epsilon-greedy action selection, replay writes into the device ring and one
DQN update per vector step, as a Python loop of ``BENCH_CHUNK`` vector steps
with no host sync inside, timed between ``torch.cuda.synchronize()`` calls
at the chunk edges.

Prints ONE JSON line as the last line of its standard output:
  {"metric": "dqn_lunarlander_env_steps_per_s", "value": steps/s,
   "unit": "env_steps/s", "vs_baseline": null, "extra": {...}}
``extra`` carries the companion benches: PPO (the on-policy rollout and
K-epoch update, Pendulum), MAPPO (3-agent MPE simple_spread, at the JAX
bench's batch and at its peak operating point), the bf16-replay variant of
the headline and the 16,384-env DQN. A failing extra fails the run. Set
``BENCH_SKIP_EXTRA=1`` for the DQN-only quick run and ``BENCH_SWEEP=1`` for
the env-batch sweep alone (one stderr line per size).

It needs a CUDA card: without one it exits non-zero, unless
``BENCH_FORCE_CPU=1`` asks for the CPU by name.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple, Optional

import torch

NUM_ENVS = int(os.environ.get("BENCH_NUM_ENVS", 4096))
CHUNK = int(os.environ.get("BENCH_CHUNK", 256))
WARMUP_CHUNKS = 2
MEASURE_CHUNKS = int(os.environ.get("BENCH_CHUNKS", 8))
# The JAX bench divides by BASELINE.md's build target, 1M env-steps/s on
# one TPU host: a number for another device. This bench reports no ratio
# until a baseline is measured on the card itself.
BASELINE_STEPS_PER_S = None

CUDA_SWEEP = (2048, 4096, 8192, 16384)
CPU_SWEEP = (256, 512)


class Run(NamedTuple):
    env_steps_per_s: float
    elapsed_s: float
    env_steps: int           # env steps in the measured window


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bench_onpolicy(env, algo, num_envs: int, steps_per_iter: int,
                    warm_iters: int = 2, measure_iters: int = 6) -> Run:
    """Steady-state env-steps/s of the on-policy driver, measured inside one
    ``train_onpolicy`` call: ``on_iter`` stamps the start once the warm
    iterations are done."""
    from freerl_tpu_torch.train.onpolicy import OnPolicyConfig, train_onpolicy

    device = env.device
    marks = {}

    def on_iter(it, n_eps, n_steps, carry, metrics):
        if it >= warm_iters and "t0" not in marks:
            # the driver does not wait for the device between iterations:
            # without this the warm block would still be running at t0
            _sync(device)
            marks["t0"], marks["s0"] = time.perf_counter(), n_steps

    cfg = OnPolicyConfig(
        num_envs=num_envs, horizon=num_envs * steps_per_iter,
        max_episodes=100_000,
        max_env_steps=num_envs * steps_per_iter
        * (warm_iters + measure_iters),
        log_every_iters=1,
        iters_per_dispatch=2,
    )
    _, _, info = train_onpolicy(env, algo, cfg, on_iter=on_iter)
    _sync(device)
    elapsed = time.perf_counter() - marks["t0"]
    steps = info["env_steps"] - marks["s0"]
    return Run(steps / elapsed, elapsed, steps)


def bench_ppo(num_envs: int = 4096, steps_per_iter: int = 64,
              device="cuda", **measure) -> Run:
    """On-policy hot path: a T-step rollout and the full K-epoch minibatch
    update per iteration, on the batched Pendulum physics."""
    from freerl_tpu_torch.algos.ppo import PPO, PPOConfig
    from freerl_tpu_torch.envs import make

    env = make("Pendulum-v1", device=device)
    horizon = num_envs * steps_per_iter
    algo = PPO(env.dim_info, PPOConfig(
        num_envs=num_envs, horizon=horizon,
        minibatch_size=min(8192, horizon), K_epochs=10, adv_norm=True,
    ), device=device)
    return _bench_onpolicy(env, algo, num_envs, steps_per_iter, **measure)


def bench_mappo(num_envs: int = 1024, steps_per_iter: int = 32,
                minibatch: Optional[int] = None, device="cuda",
                **measure) -> Run:
    """Multi-agent on-policy hot path: 3-agent simple_spread physics,
    per-agent actors and centralized critics, the full MAPPO update."""
    from freerl_tpu_torch.algos.mappo import MAPPO, MAPPOConfig
    from freerl_tpu_torch.envs import make

    env = make("simple_spread_v3", device=device)
    horizon = num_envs * steps_per_iter
    algo = MAPPO(env, MAPPOConfig(
        num_envs=num_envs, horizon=horizon, K_epochs=5,
        minibatch_size=min(minibatch or 8192, horizon),
    ), device=device)
    return _bench_onpolicy(env, algo, num_envs, steps_per_iter, **measure)


def bench_dqn(bf16_replay: bool = False, num_envs: Optional[int] = None,
              device="cuda", chunk: Optional[int] = None,
              warmup_chunks: int = WARMUP_CHUNKS,
              measure_chunks: Optional[int] = None) -> Run:
    """The headline loop: DQN (8-128-4, replay 1e6, batch 256) on
    LunarLander-v2, one learner step per vector step, ``warmup_chunks``
    chunks, then ``measure_chunks`` timed chunks of ``chunk`` vector steps
    at ``num_envs`` envs (the module's settings where not given).

    ``DQN.make_buffer`` ignores ``bf16_replay`` on the uniform path, as the
    JAX package's does, so ``bf16_replay=True`` runs the same program."""
    from freerl_tpu_torch.algos.base import ExploreCtx
    from freerl_tpu_torch.algos.dqn import DQN, DQNConfig
    from freerl_tpu_torch.core.types import Transition
    from freerl_tpu_torch.envs import make, vec_reset, vec_step_auto_reset
    from freerl_tpu_torch.train.loop import example_transition

    num_envs = num_envs or NUM_ENVS
    chunk = chunk or CHUNK
    measure_chunks = measure_chunks or MEASURE_CHUNKS
    device = torch.device(device)
    env = make("LunarLander-v2", device=device)
    algo = DQN(env.dim_info, DQNConfig(buffer_size=1_000_000, batch_size=256,
                                       bf16_replay=bf16_replay),
               device=device)
    # the counterparts of the JAX bench's k_algo, k_env and k_loop
    g_algo, g_env, g_loop = (torch.Generator(device=device).manual_seed(s)
                             for s in range(3))
    algo_state = algo.init(g_algo)
    buffer = algo.make_buffer(example_transition(env), num_envs=num_envs)
    env_state, obs = vec_reset(env, g_env, num_envs)
    ctx = ExploreCtx(
        total_env_steps=10**9,
        episodes=torch.zeros((), dtype=torch.int64, device=device),
        done_prev=torch.zeros(num_envs, dtype=torch.bool, device=device),
        random_steps=0,
    )

    def run_chunk() -> int:
        nonlocal algo_state, buffer, env_state, obs
        for _ in range(chunk):
            algo_state, action = algo.explore(algo_state, obs, g_loop, ctx)
            out = vec_step_auto_reset(env, env_state, action, g_loop,
                                      num_envs)
            buffer = buffer.add(Transition(
                obs=obs, action=action, reward=out.reward,
                next_obs=out.next_obs, done=out.terminated,
                episode_done=out.episode_done))
            algo_state, buffer, _ = algo.learn_step(algo_state, buffer,
                                                    g_loop, num_envs)
            env_state, obs = out.state, out.carry_obs
        return chunk * num_envs

    for _ in range(warmup_chunks):
        run_chunk()
    _sync(device)
    t0 = time.perf_counter()
    steps = sum(run_chunk() for _ in range(measure_chunks))
    _sync(device)
    elapsed = time.perf_counter() - t0
    return Run(steps / elapsed, elapsed, steps)


def bench_sweep(device="cuda") -> list:
    """``BENCH_SWEEP=1``: the headline loop at each env batch (2048-16384
    on the card, 256 and 512 on the CPU); one stderr line per size.
    Returns the runs."""
    sizes = CPU_SWEEP if torch.device(device).type == "cpu" else CUDA_SWEEP
    runs = []
    for n in sizes:
        runs.append(bench_dqn(num_envs=n, device=device))
        print(f"# sweep num_envs={n}: {runs[-1].env_steps_per_s:,.0f} "
              f"env_steps/s", file=sys.stderr, flush=True)
    return runs


def device_line(device: torch.device) -> str:
    """The device, and on a card its name and power limit as nvidia-smi
    gives them, with torch's and CUDA's versions."""
    if device.type != "cuda":
        return f"device=cpu torch={torch.__version__}"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return (f"device={torch.cuda.get_device_name(device)} "
            f"card=\"{card}\" torch={torch.__version__} "
            f"cuda={torch.version.cuda}")


def main() -> int:
    if os.environ.get("BENCH_FORCE_CPU"):
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        print("bench: no CUDA card (torch.cuda.is_available() is false); "
              "set BENCH_FORCE_CPU=1 to run on the CPU", file=sys.stderr)
        return 1
    if os.environ.get("BENCH_SWEEP"):
        bench_sweep(device)
        return 0
    head = bench_dqn(bf16_replay=bool(os.environ.get("BENCH_BF16_REPLAY")),
                     device=device)

    extra = {}
    if not os.environ.get("BENCH_SKIP_EXTRA"):
        extra["ppo_pendulum_env_steps_per_s"] = round(
            bench_ppo(device=device).env_steps_per_s, 1)
        # MAPPO at the JAX bench's batch, then at its peak operating point
        extra["mappo_simple_spread_env_steps_per_s"] = round(
            bench_mappo(device=device).env_steps_per_s, 1)
        extra["mappo_peak_env_steps_per_s"] = round(
            bench_mappo(num_envs=2048, steps_per_iter=128, minibatch=16384,
                        device=device).env_steps_per_s, 1)
        extra["dqn_bf16_replay_env_steps_per_s"] = round(
            bench_dqn(bf16_replay=True, device=device).env_steps_per_s, 1)
        extra["dqn_16k_envs_env_steps_per_s"] = round(
            bench_dqn(num_envs=16384, device=device).env_steps_per_s, 1)
    for k, v in [("value", head.env_steps_per_s), *extra.items()]:
        if not (math.isfinite(v) and v > 0):
            raise RuntimeError(f"bench: {k} = {v}")

    print(json.dumps({
        "metric": "dqn_lunarlander_env_steps_per_s",
        "value": round(head.env_steps_per_s, 1),
        "unit": "env_steps/s",
        "vs_baseline": BASELINE_STEPS_PER_S,
        "extra": extra,
    }), flush=True)
    print(f"# {device_line(device)} num_envs={NUM_ENVS} chunk={CHUNK} "
          f"updates/vecstep=1 elapsed={head.elapsed_s:.2f}s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
