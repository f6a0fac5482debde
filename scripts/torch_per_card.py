"""How many runs of the golden DQN recipe one card can take at once.

    python3 scripts/torch_per_card.py [--k 1 2 4 8] [--seconds 120]
        [--device cuda|cpu] [--out build/torch_per_card.json]

For each K, K processes train ``golden.SPECS[0]``'s recipe (the JAX
package's ``_DQN_LL``: LunarLander, 8 envs x 8 updates, batch 256, replay
1e6; seeds 0..K-1) through the port's ``cli.build`` and ``train_offpolicy``
on one card, all started together, for ``--seconds`` each (and at least
three chunks). A process times
its vector steps from its third chunk of 256 (after ``start_steps`` and
the first updates) to its last, and prints one JSON line. The script prints
a JSON line for each K, with the ms a vector step of each process, their
mean and max, the growth of the mean over K = 1, the env steps a second of
all K together, the host's CPU count and the card's name and power limit,
and then the largest K whose mean grows by less than 25 % as
``{"per_card": K, ...}``. It runs on the card;
without one it exits non-zero unless ``--device cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GROWTH = 1.25          # the largest K whose per-process time grows < 25 %
CHUNK = 256


class _Stop(Exception):
    pass


def worker(seed: int, seconds: float, device: str) -> dict:
    """Train one seed of the recipe for ``seconds``; the ms a vector step
    from the third chunk on."""
    from freerl_tpu_torch import cli
    from freerl_tpu_torch.train import OffPolicyConfig, train_offpolicy
    from freerl_tpu_torch.train import golden

    spec = golden.SPECS[0]
    args = cli.parser().parse_args(
        [a.format(seed=seed) for a in spec.regen] + ["--device", device])
    env, algo = cli.build(args)
    cfg = OffPolicyConfig(
        seed=args.seed, num_envs=args.num_envs,
        max_episodes=args.max_episodes, start_steps=args.start_steps,
        random_steps=args.random_steps,
        updates_per_burst=args.updates_per_burst, chunk_size=CHUNK,
        log_every_chunks=1)
    marks = []
    t0 = time.time()

    def on_chunk(chunk_i, n_eps, n_steps, carry):
        if device == "cuda":
            import torch

            torch.cuda.synchronize()
        marks.append((chunk_i, time.time()))
        if time.time() - t0 > seconds and len(marks) >= 3:
            raise _Stop

    try:
        train_offpolicy(env, algo, cfg, on_chunk=on_chunk)
    except _Stop:
        pass
    (c0, t_a), (c1, t_b) = marks[1], marks[-1]
    steps = (c1 - c0) * CHUNK
    return dict(seed=seed, vector_steps=steps,
                ms_per_vector_step=1e3 * (t_b - t_a) / max(steps, 1))


def run_k(k: int, seconds: float, device: str) -> dict:
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(seed),
         "--seconds", str(seconds), "--device", device],
        cwd=ROOT, stdout=subprocess.PIPE, text=True) for seed in range(k)]
    rows = []
    for p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"K={k}: a worker exited {p.returncode}")
        rows.append(json.loads(out.strip().splitlines()[-1]))
    ms = [r["ms_per_vector_step"] for r in rows]
    return dict(k=k, ms_per_vector_step=ms, mean_ms=sum(ms) / k,
                max_ms=max(ms),
                env_steps_per_s=sum(8e3 / m for m in ms))


def choose_k(rows: list) -> int:
    """The largest K whose mean per-process time grows by less than 25 %
    over the smallest K's."""
    return max(r["k"] for r in rows if r["growth"] < GROWTH)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "torch_per_card.json"))
    ap.add_argument("--worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        print(json.dumps(worker(args.worker, args.seconds, args.device)),
              flush=True)
        return 0
    import torch

    from chip_smoke import card_line

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_per_card: no CUDA card; pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        return 1
    host = dict(nproc=os.cpu_count(),
                affinity=len(os.sched_getaffinity(0)),
                card=card_line() if args.device == "cuda" else None)
    rows = []
    for k in sorted(args.k):
        row = run_k(k, args.seconds, args.device)
        row["growth"] = row["mean_ms"] / (rows[0]["mean_ms"] if rows
                                          else row["mean_ms"])
        rows.append(row)
        print(json.dumps({**row, **host}), flush=True)
    best = choose_k(rows)
    out = {"per_card": best, "rows": rows, **host}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"per_card": best, **host}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
