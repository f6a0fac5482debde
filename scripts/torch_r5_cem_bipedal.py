"""CEM-GD3PG BipedalWalker-v3 draws in the port (counterpart:
``scripts/r5_cem_bipedal.py``), on the card.

    python3 scripts/torch_r5_cem_bipedal.py --run R [--episodes 500]
        [--device cuda|cpu] [--root results/torch/learning_curves]
    python3 scripts/torch_r5_cem_bipedal.py --probe EPISODES [--run R]
        [--device cuda|cpu]
    python3 scripts/torch_r5_cem_bipedal.py [ARGS ...]

With ``--run``, one draw of the JAX script's recipe
(``golden.CEM_BIPEDAL_RUNS``, verbatim: ``CEMGD3PGConfig(batch_size=256,
buffer_size=1_000_000)``, the walker under ``FixedResetWrapper(seed=0)``
so every episode and population evaluation runs on the terrain seed 0
pins, and ``train_cem_gd3pg(max_episodes=500, seed=1000 * R,
start_steps=1000, full_ratio=True)``: one learner step per domain env
step). The raw curve is kept as ``golden.seed_file(ROOT, row, R)``
(``results/torch/learning_curves/BipedalWalker-v3/seeds/
CEM_GD3PG_seed_<R>.npy`` by default; never the JAX package's
``results/learning_curves/``), and the env's ``provenance.json`` records
the command, the commit (where git is there), the device and card, the
seconds, the env steps, the learner steps, the walker kernels' launches
per vector step (K2 and K3, ``ops/bipedal.py``) and the sum-tree kernel's
(B1's) launches, 0 on this path of uniform replay. Every 10 episodes the
draw prints a ``[progress]`` JSON line with those episodes' returns, so a
draw cut short leaves its curve so far in its log. It runs on the card
unless ``--device cpu`` asks; without a card it exits non-zero.

``--probe N`` runs draw ``--run`` (0 by default) for N episodes, keeps
nothing, and prints one JSON line: the seconds per walker vector
step (the rollouts' share of the time over K2's launches) and per
learner step (``learn_burst``'s share, synchronized, over its steps), and
the seconds the full 500-episode draw projects from them at the JAX
draw's counts (``PROJECT_COUNTS``).

Without ``--run`` or ``--probe``, the row of ``golden.cem_bipedal_rows``
(``BipedalWalker-v3/CEM_GD3PG_4_seed``) runs through
``scripts/torch_golden_card.py``, which takes every other argument
(``--device``, ``--per_card``, ``--force``, ``--deadline``, ``--seeds``,
``--log_dir``) and runs one draw a job.
"""
from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from freerl_tpu_torch.train import golden  # noqa: E402

STEM = "CEM_GD3PG_4_seed"
# a full draw's counts, from the JAX package's draw in
# results/r5_cem_bipedal.log (1,255,349 env steps in 500 episodes): 51
# population evaluations of 10 rows x 1,600 steps (816,000 env steps,
# 81,600 vector steps), so 439,349 domain env steps and as many learner
# steps (full_ratio); the fused 4-lane episodes run at most 1,600 vector
# steps each, which the projection takes (an upper bound)
PROJECT_COUNTS = dict(vector_steps=51 * 1600 + 500 * 1600,
                      learner_steps=1_255_349 - 51 * 10 * 1600)


def make_env(device: str, max_steps: int | None = None):
    """The JAX script's env: the walker under ``FixedResetWrapper`` at the
    recipe's reset seed, its episodes cut at ``max_steps`` where given."""
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.envs.base import FixedResetWrapper

    env_name, reset_seed, _, _ = golden.CEM_BIPEDAL_RUNS[STEM]
    walker = make(env_name, device=device)
    if max_steps is not None:
        walker.max_steps = max_steps
    return FixedResetWrapper(walker, seed=reset_seed)


def train(run: int, device: str = "cuda", algo_cls=None, draws=None,
          max_steps: int | None = None, on_episode=None, **loop) -> dict:
    """One draw of the recipe on ``device`` (``train_cem_gd3pg``'s
    arguments changed by ``loop``, the walker's episodes cut at
    ``max_steps``, ``draws`` and ``algo_cls`` as ``train_cem_gd3pg`` and a
    test take them), with the kernels' counts set to 0 just before and
    read just after: the final state, the returns, the loop's info, the
    sum-tree (B1) and walker (K2, K3) launches and the seconds."""
    from freerl_tpu_torch.algos import CEMGD3PG, CEMGD3PGConfig
    from freerl_tpu_torch.algos.cem_gd3pg import train_cem_gd3pg
    from freerl_tpu_torch.ops import bipedal, sumtree

    _, _, cfg, args = golden.CEM_BIPEDAL_RUNS[STEM]
    env = make_env(device, max_steps)
    algo = (algo_cls or CEMGD3PG)(env.dim_info, CEMGD3PGConfig(**cfg),
                                  device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    sumtree.launches = bipedal.step_launches = bipedal.reset_launches = 0
    t0 = time.time()
    state, returns, info = train_cem_gd3pg(
        env, algo, seed=golden.cem_bipedal_seed(run),
        on_episode=on_episode, draws=draws, **{**args, **loop})
    sync()
    return dict(state=state, returns=np.asarray(returns), info=info,
                launches=sumtree.launches, k2=bipedal.step_launches,
                k3=bipedal.reset_launches, seconds=time.time() - t0)


def _commit() -> str | None:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                              capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def progress(ep: int, returns: list, steps: int, t0: float) -> None:
    """Every 10 episodes, one ``[progress]`` JSON line with their
    returns."""
    if (ep + 1) % 10 == 0:
        print("[progress] " + json.dumps(dict(
            episodes=ep + 1, env_steps=steps,
            seconds=round(time.time() - t0, 1),
            returns=[round(float(x), 3) for x in returns[-10:]])),
            flush=True)


def run_draw(run: int, episodes: int, device: str, root: str) -> dict:
    """Train draw ``run`` and keep its curve and record under ``root``;
    returns the record."""
    row = golden.cem_bipedal_rows()[0]
    t0 = time.time()
    r = train(run, device, max_episodes=episodes,
              on_episode=lambda ep, rets, n: progress(ep, rets, n, t0))
    info = r["info"]
    argv = ["--run", str(run)] + (
        [] if episodes == golden.CEM_BIPEDAL_RUNS[STEM][3]["max_episodes"]
        else ["--episodes", str(episodes)])
    card = None
    if device == "cuda":
        from chip_smoke import card_line
        card = card_line()
    rec = dict(
        command=shlex.join(["python", "-m", "scripts.torch_r5_cem_bipedal",
                            *argv, "--device", device]),
        commit=_commit(), device=device, card=card,
        seconds=round(time.time() - t0, 1),
        train_seed=golden.cem_bipedal_seed(run),
        env_steps=int(info["env_steps"]),
        learner_steps=int(r["state"].step), episodes=int(info["episodes"]),
        vector_steps=int(r["k2"]) if device == "cuda" else None,
        walker_launches_per_vector_step=(
            round((r["k2"] + r["k3"]) / r["k2"], 4) if r["k2"] else None),
        b1_launches=int(r["launches"]),
        final50=round(float(r["returns"][-50:].mean()), 4))
    path = golden.seed_file(root, row, run)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, r["returns"])
    golden.update_provenance(root, row.env,
                             seeds={os.path.basename(path): rec})
    return rec


def probe(run: int, episodes: int, device: str) -> dict:
    """Draw ``run`` for ``episodes`` episodes, its learner bursts timed
    apart from the rollouts: the seconds per walker vector step and per
    learner step, and the full draw's projection."""
    from freerl_tpu_torch.algos import CEMGD3PG

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    learn = dict(seconds=0.0, steps=0)

    class Timed(CEMGD3PG):
        def learn_burst(self, state, buffer, buffer_domain, idx, *args,
                        **kw):
            sync()
            t0 = time.time()
            state = super().learn_burst(state, buffer, buffer_domain, idx,
                                        *args, **kw)
            sync()
            learn["seconds"] += time.time() - t0
            learn["steps"] += len(idx[0])
            return state

    r = train(run, device, algo_cls=Timed, max_episodes=episodes)
    rollout_s = r["seconds"] - learn["seconds"]
    per_vector = rollout_s / max(r["k2"], 1)
    per_learner = learn["seconds"] / max(learn["steps"], 1)
    projected = (per_vector * PROJECT_COUNTS["vector_steps"]
                 + per_learner * PROJECT_COUNTS["learner_steps"])
    return dict(run=run, episodes=episodes, device=device,
                seconds=round(r["seconds"], 2),
                env_steps=int(r["info"]["env_steps"]),
                vector_steps=int(r["k2"]), k3_launches=int(r["k3"]),
                learner_steps=learn["steps"],
                rollout_s=round(rollout_s, 2),
                learner_s=round(learn["seconds"], 2),
                s_per_vector_step=round(per_vector, 7),
                s_per_learner_step=round(per_learner, 7),
                projected_s_500_episodes=round(projected, 1),
                project_counts=PROJECT_COUNTS, b1_launches=r["launches"],
                returns=[round(float(x), 2) for x in r["returns"]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        epilog="without --run or --probe, other arguments go to "
               "scripts/torch_golden_card.py")
    ap.add_argument("--run", type=int, default=None)
    ap.add_argument("--probe", type=int, default=None, metavar="EPISODES")
    ap.add_argument("--episodes", type=int,
                    default=golden.CEM_BIPEDAL_RUNS[STEM][3]["max_episodes"])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--root", default=golden.OURS_ROOT,
                    help="the tree the draw's curve is kept under")
    args, rest = ap.parse_known_args(argv)
    if args.run is None and args.probe is None:
        from scripts import torch_golden_card as card

        keys = [golden.row_key(r) for r in golden.cem_bipedal_rows()]
        return card.main(keys + rest + ["--device", args.device])
    if rest:
        ap.error(f"unrecognized arguments: {rest}")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_r5_cem_bipedal: no CUDA card; pass --device cpu to run "
              "on the CPU", file=sys.stderr)
        return 1
    if args.probe is not None:
        rec = probe(args.run or 0, args.probe, args.device)
        if args.device == "cuda":
            from chip_smoke import card_line
            rec["card"] = card_line()
        print(json.dumps(rec), flush=True)
        return 0
    rec = run_draw(args.run, args.episodes, args.device, args.root)
    print(json.dumps(dict(run=args.run, **rec)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
