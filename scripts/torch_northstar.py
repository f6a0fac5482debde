"""The north-star DQN LunarLander run of the PyTorch port (counterpart:
``scripts/r5_northstar.py``): a full training run at a large env batch with
``updates_per_burst`` updates per vector step, its steady env-steps/s beside
its final-50 and final-1000 returns.

    python3 scripts/torch_northstar.py [--points 1024x8,2048x8,4096x8,4096x16]
        [--total_steps 150000000] [--seed 0] [--device cuda|cpu]
        [--out results/torch/northstar.json] [--curves_root DIR]

Each point builds the JAX script's run: DQN (replay 2^20, batch 256) on
LunarLander-v2, ``num_envs`` envs, ``start_steps`` 4096, chunks of 64 vector
steps, until ``total_steps`` env steps. The steady-state stamp is taken after
chunk 1, with the device synchronized at both stamps, so the rate is the
card's and not the depth of the host's launch queue. Each row is printed as
one JSON line, with the JAX row's keys and the card's name and power limit,
the torch version and the float32 matmul precision in force.

Among the points whose final-1000 reaches the parity bar (123.0, the JAX
script's), the fastest one's last 5000 returns are saved as
``<curves_root>/LunarLander-v2/DQN_fast_1_seed.npy``, shape (1, 5000)
float32, and printed as one JSON line. ``--out`` and ``--curves_root`` lie
in the port's own tree (``results/torch/``, where ``--curves_root``
defaults to ``learning_curves/`` beside ``--out``): nothing is written over
the JAX package's ``results/northstar.json`` or its curves.

It runs on the card; without one it exits non-zero unless ``--device cpu``
asks for the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PARITY_BAR = 123.0      # r5_northstar.py: final-1000 >= the reference mean
TAIL = 5000             # episodes of the saved curve


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_point(num_envs: int, upb: int, total_steps: int, seed: int,
              device="cuda"):
    """One operating point, as ``r5_northstar.py:run_point`` builds it.
    Returns ``(returns, row)``."""
    from chip_smoke import card_line
    from freerl_tpu_torch.algos.dqn import DQN, DQNConfig
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.train.loop import OffPolicyConfig, train_offpolicy

    device = torch.device(device)
    env = make("LunarLander-v2", device=device)
    algo = DQN(env.dim_info, DQNConfig(
        buffer_size=1_048_576, batch_size=256), device=device)
    marks = {}

    def on_chunk(chunk_i, n_eps, n_steps, carry):
        # stamp steady state after the first chunk
        if chunk_i >= 1 and "t0" not in marks:
            _sync(device)
            marks["t0"], marks["s0"] = time.time(), n_steps

    cfg = OffPolicyConfig(
        seed=seed, num_envs=num_envs,
        # the step budget binds: LunarLander averages ~300 steps/ep
        max_episodes=2_000_000, max_env_steps=total_steps,
        start_steps=4096, updates_per_burst=upb, chunk_size=64,
        log_every_chunks=1,
    )
    _, returns, info = train_offpolicy(env, algo, cfg, on_chunk=on_chunk)
    _sync(device)
    steady_sps = (info["env_steps"] - marks["s0"]) / (
        time.time() - marks["t0"])
    returns = np.asarray(returns)
    return returns, dict(
        num_envs=num_envs, updates_per_burst=upb,
        env_steps=int(info["env_steps"]), updates=int(info["updates"]),
        episodes=int(info["episodes"]),
        steady_env_steps_per_s=round(steady_sps, 1),
        wall_s=round(info["elapsed_s"], 1),
        final50=round(float(returns[-50:].mean()), 2),
        final1000=round(float(returns[-1000:].mean()), 2),
        device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu"),
        card=card_line() if device.type == "cuda" else None,
        torch=torch.__version__,
        matmul_precision=torch.get_float32_matmul_precision(),
    )


def save_tail(returns: np.ndarray, curves_root: str) -> str:
    """Save the last ``TAIL`` returns as (1, T) float32; returns the path."""
    out_dir = os.path.join(curves_root, "LunarLander-v2")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "DQN_fast_1_seed.npy")
    np.save(path, np.asarray(returns[None, -TAIL:], dtype=np.float32))
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", default="1024x8,2048x8,4096x8,4096x16")
    ap.add_argument("--total_steps", type=int, default=150_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="results/torch/northstar.json")
    ap.add_argument("--curves_root", default=None,
                    help="default: learning_curves/ beside --out")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_northstar: no CUDA card; pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        return 1
    curves_root = args.curves_root or os.path.join(
        os.path.dirname(args.out), "learning_curves")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    rows, best = [], None
    for point in args.points.split(","):
        ne, upb = (int(x) for x in point.split("x"))
        print(f"=== operating point num_envs={ne} upb={upb} ===",
              flush=True)
        returns, row = run_point(ne, upb, args.total_steps, args.seed,
                                 device=args.device)
        rows.append(row)
        print(json.dumps(row), flush=True)
        # parity = final-1000 >= the bar; among parity points keep the
        # fastest
        if row["final1000"] >= PARITY_BAR and (
            best is None
            or row["steady_env_steps_per_s"]
            > best[1]["steady_env_steps_per_s"]
        ):
            best = (returns, row)
        out = {"rows": rows, "ref_mean_final50": 123.4,
               "ref_best_seed": 235.0}
        if best is not None:
            out["best"] = best[1]
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    if best is None:
        print("NO operating point reached parity", flush=True)
        return 0
    path = save_tail(best[0], curves_root)
    tail = np.load(path)
    print(json.dumps({"curve": path, "shape": list(tail.shape),
                      "returns": [round(float(x), 2) for x in tail[0]]}),
          flush=True)
    print("best parity point:", json.dumps(best[1]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
