"""Round-5 single-agent learning curves of the port (counterpart:
``scripts/r5_singles.py``): the JAX script's ``RUNS`` table, argv and
``--fixed_reset`` protocol, through the port's CLI on the card.

    python3 scripts/torch_r5_singles.py [--only TAG,...] [ARGS ...]

Each tag is a row of ``golden.JAX_PARITY`` (``golden.r5_rows``: the stem
the JAX script writes, its seeds, and its argv as the row's recipe), and
the script runs those rows through ``scripts/torch_golden_card.py``, which
takes every other argument (``--device``, ``--per_card``, ``--force``,
``--deadline``, ``--results_root``, ``--log_dir``): one process a seed, a
seed kept already not run again unless ``--force``, the seeds stacked raw
and cut to the shortest, as the JAX script stacks them, under
``golden.OURS_ROOT`` (``results/torch/learning_curves/``, never the JAX
package's ``results/learning_curves/``), then the parity gate over every
row. Every tag runs, or those ``--only`` names, but those of
``golden.R5_LATER`` (none since the walker's step and reset run as
kernels on the card), which the script refuses.

Every run takes 500 episodes with ``--fixed_reset``: each episode of a run
starts from the state its seed pins, as the reference's training loops
reset (``r5_singles.py``'s docstring). Off-policy runs take 8 envs x 8
updates a vector step.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from freerl_tpu_torch.train import golden  # noqa: E402
from scripts import torch_golden_card as card  # noqa: E402

RUNS = golden.R5_RUNS


def row_keys(tags) -> list:
    """The row each tag's seeds run for (``golden.row_key``); the tag's
    ``@jax_head`` row reads the same curves."""
    unknown = [t for t in tags if t not in RUNS]
    if unknown:
        raise KeyError(f"unknown tags {unknown}")
    later = [t for t in tags if t in golden.R5_LATER]
    if later:
        raise ValueError(f"{later} wait for the port (golden.R5_LATER)")
    return [golden.row_key(golden.r5_rows(t)[0]) for t in tags]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        epilog="other arguments go to scripts/torch_golden_card.py")
    ap.add_argument("--only", default=None, help="comma-separated tags")
    args, rest = ap.parse_known_args(argv)
    tags = (args.only.split(",") if args.only
            else [t for t in RUNS if t not in golden.R5_LATER])
    return card.main(row_keys(tags) + rest)


if __name__ == "__main__":
    raise SystemExit(main())
