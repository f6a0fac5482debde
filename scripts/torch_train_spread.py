"""The long-protocol multi-agent run of the port (counterpart:
``scripts/train_spread.py``): the JAX script's run as a CLI argv, through
the port's CLI on the card.

    python3 scripts/torch_train_spread.py [--only TAG,...] [ARGS ...]
    python3 scripts/torch_train_spread.py --probe EPISODES [--only TAG,...]
        [--per_card K] [--device cuda|cpu] [--deadline S] [--log_dir DIR]
        [--runs_root DIR]

Each tag of ``golden.SPREAD_RUNS`` is a pair of rows of
``golden.JAX_PARITY`` (``golden.spread_rows``: the stem ``<TAG>_1_seed``,
the script's seed, and ``golden.spread_argv`` as the row's recipe: the
algorithm config and ``MARLConfig`` the JAX script builds, with random
resets), and the script runs those rows through
``scripts/torch_golden_card.py``, which takes every other argument
(``--device``, ``--per_card``, ``--force``, ``--deadline``, ``--seeds``,
``--results_root``, ``--log_dir``): a seed kept already is not run again
unless ``--force``. The run's raw ``(episodes, n_agents)`` curve is kept
under ``golden.OURS_ROOT`` (``results/torch/learning_curves/<env>/seeds/``,
never the JAX package's ``results/learning_curves/``), and beside it the
stack of its 600 bin means (``golden.bin_curve``), as the JAX package cut
its 40,000-episode curve; then the parity gate runs over every row.

``--probe EPISODES`` trains seed ``0`` of each tag for EPISODES episodes in
place of its recipe's 40,000, ``--per_card`` at once, its run dir under
``--runs_root`` (by default ``torch_golden_card.PROBE_RUNS_ROOT``, kept out
of ``--log_dir``: a run dir holds a checkpoint with the whole replay ring)
and keeps no curve; it prints one JSON line a
tag (episodes, env steps, the run's and the loop's seconds, and the
seconds a seed of the full recipe projects: the loop's rate times the
recipe's episodes, plus the run's start-up), then one line with the card
(``torch_golden_card.probe``).
To probe beside a full load, run other rows on the card in the same
command.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from freerl_tpu_torch.train import golden  # noqa: E402
from scripts import torch_golden_card as card  # noqa: E402

RUNS = golden.SPREAD_RUNS


def row_keys(tags) -> list:
    """The row each tag's run feeds (``golden.row_key``); the tag's
    ``@jax_head`` row reads the same curve."""
    unknown = [t for t in tags if t not in RUNS]
    if unknown:
        raise KeyError(f"unknown tags {unknown}")
    return [golden.row_key(golden.spread_rows(t)[0]) for t in tags]


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
    return card.probe(tags, args.probe, rest, golden.spread_argv, RUNS,
                      os.path.join(ROOT, "build", "train_spread_probe"))


if __name__ == "__main__":
    raise SystemExit(main())
