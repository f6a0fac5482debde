"""``chip_smoke.py``'s learning checks on the card: side by side, as the
chip check runs them, and, with ``--serial``, each one alone in this
process after that, so the readings of the two ways can be compared.

    python3 scripts/learning_block.py [--serial]

Side by side, as ``chip_smoke.phase_learning_block`` runs them, every check
of ``chip_smoke.LEARNING_CHECKS`` runs at once, each in a spawned process
(``chip_smoke.side_by_side``); each check's line and the block's wall time
are logged. ``--serial`` then runs ``chip_smoke.phase_learning`` for each
check, one after another in this process. The last line is one JSON object:
per check its readings (the means of the first and the last episodes it
reads) and seconds each way, whether the readings are equal, and the block's
wall time. It exits non-zero if a check fails, or, with ``--serial``, if a
reading differs between the two ways.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--serial", action="store_true",
                    help="then run each check alone, in this process")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("learning_block: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = list(chip_smoke.LEARNING_CHECKS)
    chip_smoke.log(f"[device] {chip_smoke.card_line()}")
    try:
        runs, wall = chip_smoke.side_by_side(chip_smoke.phase_learning,
                                             names)
        out = {name: dict(side_by_side=[rec["out"]["first"],
                                        rec["out"]["last"]],
                          side_by_side_s=rec["seconds"],
                          moved=rec["moved"])
               for name, rec in runs.items()}
        for name, rec in runs.items():
            chip_smoke.log(rec["out"]["line"])
        chip_smoke.log(f"[time] learning block: {wall:.1f} s")
        if args.serial:
            for name in names:
                t0 = time.time()
                got = chip_smoke.phase_learning(name)
                chip_smoke.log(got["line"])
                out[name].update(alone=[got["first"], got["last"]],
                                 alone_s=time.time() - t0)
                out[name]["equal"] = (out[name]["alone"]
                                      == out[name]["side_by_side"])
    finally:
        left = chip_smoke.stop_children()
    ok = not left and all(o.get("equal", True) and not o["moved"]
                          for o in out.values())
    print(json.dumps(dict(block_s=wall, checks=out, left=left,
                          card=chip_smoke.card_line())), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
