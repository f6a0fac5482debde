"""The N=5 multi-agent matrix of the port (counterpart:
``scripts/r5_marl_n5.py``): the JAX script's ``RUNS`` table and argv,
through the port's CLI on the card.

    python3 scripts/torch_r5_marl_n5.py [--only TAG,...] [ARGS ...]
    python3 scripts/torch_r5_marl_n5.py --probe EPISODES [--only TAG,...]
        [--per_card K] [--device cuda|cpu] [--deadline S] [--log_dir DIR]
        [--runs_root DIR]

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
tag of the table) for EPISODES episodes in place of its recipe's count,
``--per_card`` at once, its run dirs under ``--runs_root`` (by default
``torch_golden_card.PROBE_RUNS_ROOT``, out of the log dir; stopped at
``--deadline`` seconds), and keeps no curve (``torch_golden_card.probe``).
The training loop runs whole chunks or iterations, so a run may take more
episodes than asked. It prints one JSON line a tag: its episodes and env
steps, the run's seconds, the loop's seconds (env steps over the CLI's
steps/s), the seconds an episode of the loop, and the seconds a seed of the
full recipe that projects (the loop's rate times the recipe's episodes,
plus the run's start-up); then one line with the card.
"""
from __future__ import annotations

import argparse
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
    return card.probe(tags, args.probe, rest, golden.n5_argv, RUNS,
                      os.path.join(ROOT, "build", "r5_marl_n5_probe"))


if __name__ == "__main__":
    raise SystemExit(main())
