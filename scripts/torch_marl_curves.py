"""Multi-agent learning curves of the port (counterpart:
``scripts/marl_curves.py``): the JAX script's ``RUNS`` table and argv,
through the port's CLI on the card.

    python3 scripts/torch_marl_curves.py [--only ALGO,...] [ARGS ...]

Each algo is a row of ``golden.JAX_PARITY`` (``golden.marl_rows``: the
stem ``<ALGO>_1_seed`` the JAX script writes, seed 0, and its argv as the
row's recipe), and the script runs those rows through
``scripts/torch_golden_card.py``, which takes every other argument
(``--device``, ``--per_card``, ``--force``, ``--deadline``,
``--results_root``, ``--log_dir``): a seed kept already is not run again
unless ``--force``, and the run's curve is stacked raw, as the JAX script
copies it (one row, the per-agent mean return per episode), under
``golden.OURS_ROOT`` (``results/torch/learning_curves/``, never the JAX
package's ``results/learning_curves/``), then the parity gate runs over
every row. Every algo runs, or those ``--only`` names.

Every run takes 8 envs and seed 0: MATD3, HAPPO and rMAPPO 600 episodes of
simple_spread_v3, MAT 1,500 and MAAC 2,000; IPPO 600 episodes of
simple_adversary_v3.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from freerl_tpu_torch.train import golden  # noqa: E402
from scripts import torch_golden_card as card  # noqa: E402

RUNS = golden.MARL_RUNS


def row_keys(algos) -> list:
    """The row each algo's run feeds (``golden.row_key``); the algo's
    ``@jax_head`` row reads the same curve."""
    unknown = [a for a in algos if a not in RUNS]
    if unknown:
        raise KeyError(f"unknown algos {unknown}")
    return [golden.row_key(golden.marl_rows(a)[0]) for a in algos]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        epilog="other arguments go to scripts/torch_golden_card.py")
    ap.add_argument("--only", default=None, help="comma-separated algos")
    args, rest = ap.parse_known_args(argv)
    algos = args.only.split(",") if args.only else list(RUNS)
    return card.main(row_keys(algos) + rest)


if __name__ == "__main__":
    raise SystemExit(main())
