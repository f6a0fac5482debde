"""The N=5 multi-agent matrix of the port (counterpart:
``scripts/r5_marl_n5.py``): the JAX script's ``RUNS`` table and argv,
through the port's CLI on the card.

    python3 scripts/torch_r5_marl_n5.py [--only TAG,...] [ARGS ...]
    python3 scripts/torch_r5_marl_n5.py --probe EPISODES [--only TAG,...]
        [--per_card K] [--device cuda|cpu] [--deadline S] [--log_dir DIR]

Each tag is a pair of rows of ``golden.JAX_PARITY`` (``golden.n5_rows``:
the stem ``<TAG>_<k>_seed`` the JAX script writes, its seeds, 0 / 10 / 100
unless ``golden.N5_SEEDS`` says otherwise, and its argv with
``--fixed_reset`` as the row's recipe), and the script runs those rows
through ``scripts/torch_golden_card.py``, which takes every other argument
(``--device``, ``--per_card``, ``--force``, ``--deadline``, ``--seeds``,
``--results_root``, ``--log_dir``): a seed kept already is not run again
unless ``--force``, and the seeds are stacked raw as the per-agent mean
return per episode, as the JAX script stacks them, under
``golden.OURS_ROOT`` (``results/torch/learning_curves/``, never the JAX
package's ``results/learning_curves/``); then the parity gate runs over
every row. The tags run in the order ``--only`` gives (the card runner
starts its jobs in that order), every tag by default.

``--probe EPISODES`` trains seed ``0`` of each tag (``--only``, or every
tag of the table) for EPISODES episodes in place of
its recipe's count, ``--per_card`` at once, under ``<log_dir>/runs``
(stopped at ``--deadline`` seconds), and keeps no curve. The driver runs
whole chunks or iterations, so a run may take more episodes than asked. It
prints one JSON line a tag: its episodes and env steps, the run's seconds,
the loop's seconds (env steps over the CLI's steps/s), the seconds an
episode of the loop, and the seconds a seed of the full recipe that
projects (the loop's rate times the recipe's episodes, plus the run's
start-up); then one line with the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from freerl_tpu_torch.train import golden  # noqa: E402
from scripts import torch_golden_card as card  # noqa: E402

RUNS = golden.N5_RUNS


def row_keys(tags) -> list:
    """The row each tag's runs feed (``golden.row_key``); the tag's
    ``@jax_head`` row reads the same curves."""
    unknown = [t for t in tags if t not in RUNS]
    if unknown:
        raise KeyError(f"unknown tags {unknown}")
    return [golden.row_key(golden.n5_rows(t)[0]) for t in tags]


def probe_jobs(tags, episodes: int, device: str, runs_root: str) -> list:
    """One job a tag: seed 0 of its argv for ``episodes`` episodes."""
    jobs = []
    for tag in tags:
        argv = golden.n5_argv(tag, 0, results_root=runs_root)
        argv[argv.index("--max_episodes") + 1] = str(episodes)
        jobs.append(dict(name=f"probe_{tag}", row=tag, argv=[
            sys.executable, "-m", "freerl_tpu_torch.cli", *argv,
            "--device", device]))
    return jobs


def probe_record(job: dict) -> dict:
    """What one probe job's log says of its speed, and the seconds a seed of
    the tag's full recipe projects."""
    out = dict(tag=job["row"], rc=job.get("rc"), seconds=job.get("seconds"))
    if job.get("rc") != 0:
        return out
    with open(job["log"]) as f:
        info = golden.parse_run_log(f.read())
    loop_s = info["env_steps"] / max(info["steps_per_s"], 1)
    per_episode = loop_s / info["episodes"]
    full = RUNS[job["row"]][2]
    out.update(episodes=info["episodes"], env_steps=info["env_steps"],
               b1_launches=info.get("b1_launches"),
               loop_s=round(loop_s, 2), s_per_episode=round(per_episode, 5),
               projected_s_a_seed=round(
                   per_episode * full + job["seconds"] - loop_s, 1))
    return out


def probe(tags, episodes: int, device: str, per_card: int, log_dir: str,
          deadline=None) -> int:
    from chip_smoke import card_line, stop_children

    os.makedirs(log_dir, exist_ok=True)
    jobs = probe_jobs(tags, episodes, device, os.path.join(log_dir, "runs"))
    try:
        card.run_jobs(jobs, device, log_dir, deadline, per_card)
    finally:
        left = stop_children()
    for j in jobs:
        print(json.dumps(probe_record(j)), flush=True)
    print(json.dumps({"per_card": per_card, "device": device,
                      "card": card_line() if device == "cuda" else None,
                      "left_running": left}), flush=True)
    return 0 if not left and all(j.get("rc") == 0 for j in jobs) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        epilog="other arguments go to scripts/torch_golden_card.py")
    ap.add_argument("--only", default=None, help="comma-separated tags")
    ap.add_argument("--probe", type=int, default=None, metavar="EPISODES",
                    help="time seed 0 of each tag for EPISODES episodes")
    args, rest = ap.parse_known_args(argv)
    tags = args.only.split(",") if args.only else list(RUNS)
    keys = row_keys(tags)
    if args.probe is None:
        return card.main(keys + rest)
    pa = argparse.ArgumentParser()
    pa.add_argument("--per_card", type=int, default=1)
    pa.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    pa.add_argument("--deadline", type=float, default=None)
    pa.add_argument("--log_dir", default=os.path.join(ROOT, "build",
                                                      "r5_marl_n5_probe"))
    p = pa.parse_args(rest)
    return probe(tags, args.probe, p.device, p.per_card, p.log_dir,
                 p.deadline)

if __name__ == "__main__":
    raise SystemExit(main())
