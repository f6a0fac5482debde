"""The start state each fixed-reset parity row's seeds pin in the port, on
the card (or the CPU): what ``--fixed_reset`` trains every episode from.

    python3 scripts/torch_reset_starts.py [--device cuda|cpu]

For every row of ``golden.JAX_PARITY`` whose recipe takes ``--fixed_reset``
and each of its seeds, the env is built on the device as the port's CLI
builds it (``golden.pinned_start``, through ``cli.build_env``) and its
start observation read. The port pins the JAX package's start: the draw
the JAX env makes in ``reset(jax.random.PRNGKey(seed))``, recomputed on the
host (``core/jax_prng.py``), so the start is the same on the card, on the
CPU and in the JAX package. Beside each start, ``same_as_jax`` says whether
it is the start the JAX package pinned for that seed as the row's
``@jax_head`` provenance records it (``golden.same_start``: within
``golden.START_ULPS`` float32 ulps), or null where no such record exists.
One JSON line gives them by env and by the seed that pins the start (the
recipe's ``--reset_seed``, else the seed), with the card's name and power
limit. Without a card it exits non-zero unless ``--device cpu`` asks for
the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from freerl_tpu_torch.train import golden  # noqa: E402


def jax_start(row: golden.GoldenSpec, seed: int):
    """The start the JAX package pinned for one seed of ``row``'s recipe,
    as ``golden.JAX_HEAD_ROOT``'s provenance records it, or None."""
    path = os.path.join(golden.JAX_HEAD_ROOT, row.env, "provenance.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        rec = json.load(f).get("seeds", {}).get(os.path.basename(
            golden.seed_file(golden.JAX_HEAD_ROOT, row, seed)))
    if (rec is None or golden.recipe_of(rec["command"])
            != [a.format(seed=seed) for a in row.regen]):
        return None
    return rec.get("start")


def starts(device: str) -> tuple:
    """``({env: {seed: start}}, {env: {seed: same as JAX's, or None}})``
    over the fixed-reset rows."""
    out, same = {}, {}
    for row in golden.JAX_PARITY:
        if "--fixed_reset" not in row.regen:
            continue
        for seed in row.regen_seeds:
            key = str(golden.start_seed(row, seed))
            if key in out.get(row.env, {}):
                continue
            obs = golden.pinned_start(row, seed, device)
            want = jax_start(row, seed)
            out.setdefault(row.env, {})[key] = obs
            same.setdefault(row.env, {})[key] = (
                None if want is None else golden.same_start(obs, want))
    return out, same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_reset_starts: no CUDA card; pass --device cpu to run "
              "on the CPU", file=sys.stderr)
        return 1
    from chip_smoke import card_line

    got, same = starts(args.device)
    print(json.dumps({"device": args.device,
                      "card": card_line() if args.device == "cuda" else None,
                      "starts": got, "same_as_jax": same}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
