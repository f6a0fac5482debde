"""Time the sum-tree descent kernel's (K, G) variants on one CUDA card.

    python3 scripts/sumtree_sweep.py [--variants 4x16,5x32,7x32] [--baseline OTHER.cu]

``freerl_tpu_torch/csrc/sumtree_descend.cu`` descends K levels per load
round with a group of G lanes per sample; the pair is fixed at compile time
(``SUMTREE_LEVELS_PER_ROUND``, ``SUMTREE_GROUP``). This script builds one
library per pair with ``nvcc -D...`` into ``build/kernels/sweep/`` (all
compiles at once), plus ``--baseline``, any other source with the same C
entry point (an earlier version of the kernel, say). Then, for each:

1. holds it bit for bit against the plain twin ``sumtree_descend_ref`` in
   every case of ``chip_smoke.py`` phase 3;
2. at the main path's shape (cap 2^20, depth 20, B 256) times it per call
   with L2 warm and cold, as ``chip_smoke.py`` does (CUDA graph of
   back-to-back calls between CUDA events; cold: a 128 MB write before
   each call, its time taken off). Every library is timed twice, in the
   order given and then in reverse, so drift within the call shows.

Beside them: the empty-kernel floor of one launch on the shipped kernel's
grid, and ``torch.searchsorted`` over the leaf cumsum (warm and cold). Then
the host's share of one eager call, each the median of alternating rounds:
the shipped wrapper; its output allocation alone; its C entry point called
through ctypes with the output preallocated and no checks; the empty kernel
launched the same way; and one ``torch.searchsorted`` call. Prints a table,
then everything as one JSON line, then the card line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from freerl_tpu_torch.ops import _build, sumtree  # noqa: E402

SWEEP_DIR = _build.BUILD_DIR / "sweep"


def compile_all(jobs: dict[str, tuple[Path, tuple[str, ...]]]) -> dict:
    """``{label: (source, extra nvcc flags)}`` -> ``{label: library path}``;
    one nvcc per library, all started together."""
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for label, (src, flags) in jobs.items():
        out = SWEEP_DIR / f"lib{label}.so"
        procs[label] = (out, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *flags, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (out, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{report}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                cs.log(f"[build] {label}: {line.strip()}")
        libs[label] = out
    return libs


def entry(path: Path):
    """The library's ``sumtree_descend_launch`` as a call that writes into
    a preallocated ``out`` on the current stream."""
    fn = ctypes.CDLL(str(path)).sumtree_descend_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(tree, u, depth, cap, out):
        rc = fn(tree.data_ptr(), u.data_ptr(), out.data_ptr(), u.numel(),
                depth, cap, torch._C._cuda_getCurrentRawStream(0))
        if rc:
            raise RuntimeError(f"{path.name}: CUDA error {rc}")
        return out
    return call


def check(label: str, call) -> int:
    n = 0
    for case, _, tree, depth, cap, u in cs.sumtree_cases():
        out = call(tree, u, depth, cap, torch.empty_like(u, dtype=torch.int32))
        if not torch.equal(out, sumtree.sumtree_descend_ref(tree, u, depth,
                                                            cap)):
            raise AssertionError(f"{label} differs from the twin at {case}")
        n += 1
    return n


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants",
                    default="4x16,5x32,6x32,7x32,8x32,6x16,7x16,9x32,10x32",
                    help="comma-separated KxG pairs")
    ap.add_argument("--baseline", default=None,
                    help="another source with the same C entry point")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sumtree_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    card = cs.card_line()
    cs.log(f"[device] {torch.cuda.get_device_name(0)} | {card}")

    src = _build.CSRC_DIR / "sumtree_descend.cu"
    jobs = {}
    for pair in args.variants.split(","):
        k, g = (int(x) for x in pair.split("x"))
        jobs[f"k{k}_g{g}"] = (src, (f"-DSUMTREE_LEVELS_PER_ROUND={k}",
                                    f"-DSUMTREE_GROUP={g}"))
    if args.baseline:
        jobs["baseline"] = (Path(args.baseline), ())
    _build.build_all(["sumtree_descend"])
    calls = {label: entry(path) for label, path in compile_all(jobs).items()}
    for label, call in calls.items():
        cs.log(f"[check] {label}: == twin bit for bit in "
               f"{check(label, call)} cases")

    cap = 1 << cs.MAIN_CAP_POW
    tree, depth = cs.build_tree(cap, seed=1)
    u = cs.stratified_u(tree, cs.MAIN_BATCH, seed=2)
    out = torch.empty_like(u, dtype=torch.int32)
    cdf = torch.cumsum(tree[cap:], 0)
    empty = cs.floor_launcher(cs.MAIN_BATCH)

    def library():
        return torch.searchsorted(cdf, u)

    def shipped():
        return sumtree.sumtree_descend(tree, u, depth, cap)

    shipped_entry = entry(_build.lib_path("sumtree_descend"))

    times: dict[str, dict[str, list[float]]] = {
        label: {"ms": [], "cold_ms": []} for label in calls}
    for order in (list(calls), list(calls)[::-1]):
        for label in order:
            fn = (lambda c=calls[label]: c(tree, u, depth, cap, out))
            times[label]["ms"].append(cs.device_ms(fn))
            times[label]["cold_ms"].append(cs.cold_ms(fn)[0])
    result = {
        "card": card,
        "shape": {"capacity": cap, "depth": depth, "batch": cs.MAIN_BATCH},
        "variants": times,
        "floor_ms": cs.device_ms(empty),
        "library_ms": cs.device_ms(library),
        "library_cold_ms": cs.cold_ms(library)[0],
        "eager_ms": cs.eager_medians({
            "wrapper": shipped,
            "allocation": lambda: torch.empty_like(u, dtype=torch.int32),
            "entry_point": lambda: shipped_entry(tree, u, depth, cap, out),
            "empty_kernel": empty,
            "torch.searchsorted": library,
        }),
    }
    for label, t in times.items():
        cs.log(f"[time] {label:>9}: warm {t['ms'][0]:.6f} / {t['ms'][1]:.6f}"
               f" ms, cold {t['cold_ms'][0]:.6f} / {t['cold_ms'][1]:.6f} ms")
    cs.log(f"[time] empty-kernel floor {result['floor_ms']:.6f} ms; "
           f"torch.searchsorted warm {result['library_ms']:.6f} ms, cold "
           f"{result['library_cold_ms']:.6f} ms")
    cs.log("[eager] " + ", ".join(
        f"{name} {ms:.6f} ms" for name, ms in result["eager_ms"].items()))
    print(json.dumps(result))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
