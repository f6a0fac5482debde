"""Data-parallel scaling sweep of the PyTorch port, and two learning curves
through its sharded drivers (counterpart: ``scripts/dp_scaling.py``).

    python3 scripts/torch_dp_scaling.py [--device cuda|cpu]
        [--ranks 1 2 4 8] [--envs_per_device 8] [--steps 8192]
        [--out build/torch_dp_scaling.json] [--no-curves]
        [--curves_root DIR]

At each rank count, one process per rank joins a ``torch.distributed``
group (``distributed.multihost.initialize``, a file rendezvous, a timeout
on every group) and builds the mesh ``dp`` (``distributed.make_mesh``);
then three sweeps run through the drivers' ``mesh=``, with the JAX
script's sizes: DQN on CartPole-v1 (``train_offpolicy``), PPO on CartPole-v1
(``train_onpolicy``) and MADDPG on simple_spread_v3 (``train_marl``), each
row the aggregate env-steps/s over the ranks. Then the two curves train
through the sharded path at the largest rank count (at most 8): DQN on
CartPole-v1 and MADDPG on simple_spread_v3, saved as
``CartPole-v1/DQN_dp<n>_1_seed.npy`` and
``simple_spread_v3/MADDPG_dp<n>_1_seed.npy`` under the port's curves root
(``train/golden.py``'s ``OURS_ROOT``), never over the JAX package's.

``--device cuda`` (the default) runs NCCL with one rank per card and stops
at ``torch.cuda.device_count()``; it runs no ranks that share a card.
``--device cpu`` runs gloo ranks on the CPU: they share one host, and the
JSON says so (``"shared_host": true``), so its rows show that the sharded
program runs at every size, not how it scales. Prints each row and writes
the JSON to ``--out``, under the git-ignored ``build/`` by default.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RANKS = (1, 2, 4, 8)
SWEEPS = ("dqn", "ppo", "maddpg")
CURVES = ("dqn_curve", "maddpg_curve")
GROUP_TIMEOUT_S = 300


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------
def _row(n: int, cfg, info: dict, count: str) -> dict:
    return dict(n_ranks=n, num_envs=cfg.num_envs,
                env_steps=info["env_steps"],
                env_steps_per_s=info["env_steps_per_s"],
                **{count: info[count]})


def run_job(job: str, mesh, p: dict):
    """One sweep row, or one curve, on this rank; returns what rank 0
    reports."""
    import numpy as np

    from freerl_tpu_torch.algos import (DQN, MADDPG, PPO, DQNConfig,
                                        MADDPGConfig, PPOConfig)
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.train import (MARLConfig, OffPolicyConfig,
                                        OnPolicyConfig, train_marl,
                                        train_offpolicy, train_onpolicy)

    n, dev = mesh.size, mesh.device
    epd, steps = p["envs_per_device"], p["steps"]
    if job in ("dqn", "dqn_curve"):
        env = make("CartPole-v1", device=dev)
        algo = DQN(env.dim_info, DQNConfig(buffer_size=20_000, batch_size=64,
                                           axis_name="dp"), device=dev)
        if job == "dqn":
            cfg = OffPolicyConfig(num_envs=epd * n, max_episodes=10**9,
                                  max_env_steps=epd * n * steps,
                                  start_steps=500, chunk_size=256)
            _, _, info = train_offpolicy(env, algo, cfg, mesh=mesh)
            return _row(n, cfg, info, "updates")
        cfg = OffPolicyConfig(num_envs=16, max_episodes=250,
                              start_steps=500, updates_per_burst=8,
                              chunk_size=128)
        _, curve, _ = train_offpolicy(env, algo, cfg, mesh=mesh)
        return {"name": f"CartPole-v1/DQN_dp{n}_1_seed.npy",
                "curve": np.asarray(curve), "window": 30}
    if job == "ppo":
        env = make("CartPole-v1", device=dev)
        nenv = epd * n
        algo = PPO(env.dim_info, PPOConfig(
            horizon=128 * nenv, minibatch_size=64, num_envs=nenv,
            adv_norm=True, axis_name="dp"), device=dev)
        cfg = OnPolicyConfig(num_envs=nenv, max_episodes=10**9,
                             max_env_steps=nenv * steps // 2,
                             horizon=128 * nenv)
        _, _, info = train_onpolicy(env, algo, cfg, mesh=mesh)
        return _row(n, cfg, info, "iterations")
    env = make("simple_spread_v3", device=dev)
    algo = MADDPG(env, MADDPGConfig(buffer_size=20_000, batch_size=64,
                                    axis_name="dp"), device=dev)
    if job == "maddpg":
        nenv = max(epd // 4, 2) * n
        cfg = MARLConfig(num_envs=nenv, max_episodes=10**9,
                         max_env_steps=nenv * steps // 8, start_steps=500,
                         chunk_size=64)
        _, _, info = train_marl(env, algo, cfg, mesh=mesh)
        return _row(n, cfg, info, "updates")
    cfg = MARLConfig(num_envs=16, max_episodes=600,
                     start_steps=500, updates_per_burst=2, chunk_size=64)
    _, curve, _ = train_marl(env, algo, cfg, mesh=mesh)
    return {"name": f"simple_spread_v3/MADDPG_dp{n}_1_seed.npy",
            "curve": np.asarray(curve).mean(axis=-1)[None], "window": 50}


def worker(rank: int, world: int, d: str) -> int:
    """A rank: join the group through a file in ``d``, build the mesh, run
    ``d/job.json``'s jobs in order; rank 0 saves the results to
    ``d/result.pt``."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    from freerl_tpu_torch.distributed import make_mesh, multihost

    with open(os.path.join(d, "job.json")) as f:
        spec = json.load(f)
    torch.set_num_threads(spec["threads"])
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    try:
        multihost.initialize(f"file://{d}/rendezvous", world, rank,
                             timeout=timeout)
        mesh = make_mesh(axis="dp", device=spec["device"], timeout=timeout)
        out = {job: run_job(job, mesh, spec["params"])
               for job in spec["jobs"]}
        if rank == 0:
            torch.save(out, os.path.join(d, "result.pt"))
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------
def run_ranks(n_ranks: int, jobs, params: dict, device: str = "cuda",
              timeout: float = 3600.0) -> dict:
    """Spawn ``n_ranks`` ranks that run ``jobs`` in order; returns rank 0's
    results by job. A rank that fails or outlives ``timeout`` seconds fails
    the call, and none is left running."""
    import torch

    threads = 1 if device == "cpu" else 2
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "job.json"), "w") as f:
            json.dump(dict(jobs=list(jobs), params=params, device=device,
                           threads=threads), f)
        env = dict(os.environ, OMP_NUM_THREADS=str(threads))
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(r),
             str(n_ranks), d], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
            for r in range(n_ranks)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"torch_dp_scaling: rank {r} of {n_ranks} "
                                   f"failed:\n{out[-4000:]}")
        return torch.load(os.path.join(d, "result.pt"), weights_only=False)


def sweep(n_ranks: int, device: str = "cuda", envs_per_device: int = 8,
          steps: int = 8192, timeout: float = 3600.0) -> dict:
    """The three sweeps' rows at ``n_ranks`` ranks, by sweep."""
    return run_ranks(n_ranks, SWEEPS, dict(envs_per_device=envs_per_device,
                                           steps=steps), device, timeout)


def rank_counts(device: str, wanted=RANKS) -> list:
    """The rank counts to run: all of ``wanted`` on the CPU; on CUDA those
    that give each rank a card of its own."""
    if device == "cpu":
        return list(wanted)
    import torch

    return [n for n in wanted if n <= torch.cuda.device_count()]


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        return worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", type=int, nargs="*", default=list(RANKS))
    ap.add_argument("--envs_per_device", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8192,
                    help="per-rank vector steps of the DQN sweep")
    ap.add_argument("--no-curves", dest="curves", action="store_false")
    ap.add_argument("--curves_root", default=None,
                    help="default: train/golden.py's OURS_ROOT")
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "torch_dp_scaling.json"))
    args = ap.parse_args()

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_dp_scaling: no CUDA card; pass --device cpu to run gloo "
              "ranks on the CPU", file=sys.stderr)
        return 1
    counts = rank_counts(args.device, args.ranks)
    result = {"device": (torch.cuda.get_device_name(0)
                         if args.device == "cuda" else "cpu"),
              "shared_host": args.device == "cpu",
              "sweep": [], "onpolicy_sweep": [], "marl_sweep": []}
    for n in counts:
        rows = sweep(n, args.device, args.envs_per_device, args.steps)
        for key, job in zip(("sweep", "onpolicy_sweep", "marl_sweep"),
                            SWEEPS):
            result[key].append(rows[job])
            print(job, rows[job], flush=True)

    if args.curves and counts:
        from freerl_tpu_torch.train.golden import OURS_ROOT

        root = args.curves_root or OURS_ROOT
        n = max(c for c in counts if c <= 8)
        curves = run_ranks(n, CURVES, dict(
            envs_per_device=args.envs_per_device, steps=args.steps),
            args.device)
        for job in CURVES:
            c = curves[job]
            path = os.path.join(root, c["name"])
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, c["curve"])
            final = float(c["curve"][..., -c["window"]:].mean())
            result[f"{job}_ranks"] = n
            result[f"{job}_final{c['window']}"] = final
            print(f"{c['name']}: final-{c['window']} {final:.1f}, saved "
                  f"{path}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
