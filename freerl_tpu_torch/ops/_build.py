"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``freerl_tpu_torch/csrc/<name>.cu`` exposes a plain C entry point and is
compiled on first use into its own shared library,
``build/kernels/lib<name>.so`` at the root of the checkout. ``build_all``
starts one ``nvcc`` per source, all at once, and waits for them; ``load``
builds what is missing or older than its source and returns the loaded
library. A build holds an exclusive ``flock`` on ``build/kernels/lock``,
so processes that start together (the ranks of a data-parallel run) build
each library once and never read one half written; the kernel frees the
lock of a process that dies. The compiler's ``-Xptxas -v`` report (registers, shared memory,
spills) is kept beside each library as ``lib<name>.ptxas.txt``.

Nothing here runs at import time: the CPU tests import every module, and
there is no ``nvcc`` where they run.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "port's CUDA kernels are built on the machine with the card"
        )
    return found


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = lib_path(name)
    src = CSRC_DIR / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


@contextlib.contextmanager
def _build_lock():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile the given sources (default: every stale one) in parallel,
    under the build lock; a source another process built while this one
    waited is not built again.

    Returns ``{name: ptxas report}``. Raises if any compile fails.
    """
    with _build_lock():
        return _build_stale(names or sources())


def _build_stale(names: list[str]) -> dict[str, str]:
    names = [n for n in names if _stale(n)]
    if not names:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name in names:
        tmp = BUILD_DIR / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{report}")
            continue
        os.replace(tmp, lib_path(name))
        (BUILD_DIR / f"lib{name}.ptxas.txt").write_text(report)
        reports[name] = report
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library for ``csrc/<name>.cu``, building it first
    if it is missing or older than its source."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _loaded[name] = lib
    return lib
