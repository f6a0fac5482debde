"""The start state each fixed-reset parity row's seeds pin in the port, on
the card (or the CPU): what ``--fixed_reset`` trains every episode from.

    python3 scripts/torch_reset_starts.py [--device cuda|cpu]

For every row of ``golden.JAX_PARITY`` whose recipe takes ``--fixed_reset``
and each of its seeds, the port's ``FixedResetWrapper`` is built on the
device as the CLI builds it and its start observation read. One JSON line
gives them by env and seed, with the card's name and power limit. The
torch generator draws another stream on the card than on the CPU, and
neither is the JAX package's, so a row of ``golden.NOT_COMPARABLE`` holds
different tasks on the two sides. Without a card it exits non-zero unless
``--device cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from freerl_tpu_torch.envs import make  # noqa: E402
from freerl_tpu_torch.envs.base import FixedResetWrapper  # noqa: E402
from freerl_tpu_torch.train import golden  # noqa: E402


def starts(device: str) -> dict:
    """``{env: {seed: start observation}}`` over the fixed-reset rows."""
    out = {}
    for row in golden.JAX_PARITY:
        if "--fixed_reset" not in row.regen:
            continue
        for seed in row.regen_seeds:
            env = FixedResetWrapper(make(row.env, device=device), seed)
            _, obs = env.reset(env._reset_draw)
            out.setdefault(row.env, {})[str(seed)] = [
                round(float(x), 6) for x in obs[0].flatten().tolist()]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_reset_starts: no CUDA card; pass --device cpu to run "
              "on the CPU", file=sys.stderr)
        return 1
    from chip_smoke import card_line

    print(json.dumps({"device": args.device,
                      "card": card_line() if args.device == "cuda" else None,
                      "starts": starts(args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
