"""Train the port's learning-curve rows, one card per run, and hold them
against the JAX package's committed curves.

    python3 scripts/torch_golden_card.py [--northstar 4096x8] [ENV/STEM ...]
        [--device cuda|cpu] [--total_steps 150000000] [--deadline SECONDS]
        [--results_root results/torch] [--log_dir build/golden_card]

The jobs: the north-star point (``scripts/torch_northstar.py`` at
``--northstar``, seed 0) and, for each ``ENV/STEM`` of
``golden.JAX_PARITY``, one run of the row's recipe per seed through the
port's CLI (``golden.regen_argv``, as ``golden.regenerate`` runs it). Each
job is a process of its own. On the card each process sees one card
(``CUDA_VISIBLE_DEVICES``): the jobs are dealt to the cards in turn, and a
card runs its jobs one after another, so four cards run the north star and
three seeds at once. ``--device cpu`` runs the jobs one after another on the
CPU.

When every seed of a row has finished, the seeds are stacked with
``golden.save_stack`` under ``golden.OURS_ROOT`` and the stack is printed as
one JSON line. The north-star job writes ``<results_root>/northstar.json``
and its tail curve under ``golden.OURS_ROOT``. Each job's output goes to
``<log_dir>/<job>.log``, and every artifact is copied into ``--log_dir`` as
well. Then the parity gate (``golden.check_against_jax``) runs over
``golden.JAX_PARITY``, and a last JSON line gives each job and each row.

At ``--deadline`` seconds the jobs still running are stopped and read as
cut; their rows stay absent (``missing``). No child outlives the script. It
exits non-zero if a job failed or was cut, or a row fails its gate. It runs
on the card; without one it exits non-zero unless ``--device cpu`` asks for
the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from freerl_tpu_torch.train import golden  # noqa: E402

NORTHSTAR = "LunarLander-v2/DQN_fast_1_seed"


def parity_row(key: str) -> golden.GoldenSpec:
    for spec in golden.JAX_PARITY:
        if f"{spec.env}/{spec.algo}" == key:
            return spec
    raise KeyError(f"{key!r} is not a row of golden.JAX_PARITY")


def make_jobs(northstar, keys, total_steps, device, results_root) -> list:
    """One dict per process: its name, argv, and the row it feeds."""
    jobs = []
    if northstar:
        jobs.append(dict(
            name=f"northstar_{northstar}", row=NORTHSTAR, argv=[
                sys.executable, os.path.join(ROOT, "scripts",
                                             "torch_northstar.py"),
                "--points", northstar, "--total_steps", str(total_steps),
                "--seed", "0", "--device", device,
                "--out", os.path.join(results_root, "northstar.json"),
                "--curves_root", golden.OURS_ROOT]))
    for key in keys:
        spec = parity_row(key)
        if not spec.regen:
            raise ValueError(f"{key} has no recipe: the north star runs "
                             f"through --northstar")
        for seed in spec.regen_seeds:
            jobs.append(dict(
                name=f"{spec.env}_{spec.algo}_seed_{seed}", row=key,
                seed=seed, argv=[sys.executable, "-m", "freerl_tpu_torch.cli",
                                 *golden.regen_argv(spec, seed, results_root,
                                                    device)]))
    return jobs


def _stop(proc: subprocess.Popen) -> None:
    """End a job's process group and reap it."""
    for sig, wait in ((signal.SIGTERM, 10), (signal.SIGKILL, 30)):
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            return
        try:
            proc.wait(wait)
            return
        except subprocess.TimeoutExpired:
            continue


def deal(jobs: list, n_cards: int) -> list:
    """The jobs dealt to the cards in turn: one queue per card."""
    return [jobs[i::n_cards] for i in range(n_cards)]


def run_jobs(jobs: list, device: str, log_dir: str,
             deadline: float | None) -> None:
    """Run the jobs, one process per card at a time; fill each job's
    ``rc`` (None: cut at the deadline or never started), ``card``,
    ``seconds`` and ``log``."""
    n_slots = torch.cuda.device_count() if device == "cuda" else 1
    queues = deal(jobs, n_slots)
    running = {}                    # slot -> (job, Popen, file, t0)
    t_start = time.time()
    try:
        while any(queues) or running:
            for slot in range(n_slots):
                if slot in running or not queues[slot]:
                    continue
                job = queues[slot].pop(0)
                env = dict(os.environ)
                if device == "cuda":
                    env["CUDA_VISIBLE_DEVICES"] = str(slot)
                job.update(card=slot if device == "cuda" else None,
                           log=os.path.join(log_dir, job["name"] + ".log"))
                f = open(job["log"], "w")
                proc = subprocess.Popen(job["argv"], cwd=ROOT, env=env,
                                        stdout=f, stderr=subprocess.STDOUT,
                                        start_new_session=True)
                running[slot] = (job, proc, f, time.time())
                print(f"[start] {job['name']} on "
                      f"{'card ' + str(slot) if device == 'cuda' else 'cpu'}",
                      flush=True)
            for slot, (job, proc, f, t0) in list(running.items()):
                if proc.poll() is None:
                    continue
                f.close()
                job.update(rc=proc.returncode,
                           seconds=round(time.time() - t0, 1))
                del running[slot]
                print(f"[end] {job['name']}: rc {job['rc']} in "
                      f"{job['seconds']} s", flush=True)
            if deadline is not None and time.time() - t_start > deadline:
                print(f"[deadline] {deadline} s: stopping "
                      f"{[j['name'] for j, *_ in running.values()]}",
                      flush=True)
                break
            time.sleep(1.0)
    finally:
        for job, proc, f, t0 in running.values():
            _stop(proc)
            f.close()
            job.update(rc=None, seconds=round(time.time() - t0, 1))


def _model_dir(log: str) -> str:
    with open(log) as f:
        for line in f:
            if line.startswith("model_dir: "):
                return line.split(": ", 1)[1].strip()
    raise RuntimeError(f"{log}: no model_dir line")


def _mirror(path: str, log_dir: str, env: str) -> None:
    shutil.copy(path, os.path.join(log_dir,
                                   f"{env}__{os.path.basename(path)}"))


def stack_rows(jobs: list, log_dir: str) -> None:
    """Stack the seeds of every recipe row whose seeds all finished, print
    each stack as one JSON line, and copy the curves into ``log_dir``."""
    for key in dict.fromkeys(j["row"] for j in jobs if "seed" in j):
        spec = parity_row(key)
        mine = [j for j in jobs if j["row"] == key]
        if any(j.get("rc") != 0 for j in mine):
            print(f"[stack] {key}: not every seed finished; not stacked",
                  flush=True)
            continue
        curves = []
        for j in mine:
            run_dir = _model_dir(j["log"])
            curves.append(golden.seed_curve(spec, run_dir, j["seed"]))
            for name in os.listdir(run_dir):
                if name.endswith(".npy"):
                    _mirror(os.path.join(run_dir, name), log_dir, spec.env)
        golden.save_stack(spec, curves)
        path = os.path.join(golden.OURS_ROOT, spec.env, spec.algo + ".npy")
        _mirror(path, log_dir, spec.env)
        stack = np.load(path)
        print(json.dumps({
            "stack": key, "shape": list(stack.shape),
            "seeds": list(spec.regen_seeds),
            "episodes": [len(c) for c in curves],
            f"final{spec.window}": [round(float(x), 2) for x in
                                    stack[:, -spec.window:].mean(1)],
            "returns": [[round(float(x), 2) for x in s] for s in stack]}),
            flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("rows", nargs="*",
                    help="ENV/STEM rows of golden.JAX_PARITY with a recipe")
    ap.add_argument("--northstar", default=None,
                    help="the north-star point NUM_ENVSxUPB, e.g. 4096x8")
    ap.add_argument("--total_steps", type=int, default=150_000_000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--deadline", type=float, default=None,
                    help="seconds after which running jobs are stopped")
    ap.add_argument("--results_root",
                    default=os.path.join(ROOT, "results", "torch"))
    ap.add_argument("--log_dir",
                    default=os.path.join(ROOT, "build", "golden_card"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_golden_card: no CUDA card; pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        return 1
    jobs = make_jobs(args.northstar, args.rows, args.total_steps,
                     args.device, args.results_root)
    os.makedirs(args.log_dir, exist_ok=True)
    from chip_smoke import stop_children

    try:
        run_jobs(jobs, args.device, args.log_dir, args.deadline)
        stack_rows(jobs, args.log_dir)
    finally:
        left = stop_children()
    for j in jobs:
        if j["row"] == NORTHSTAR and j.get("rc") == 0:
            shutil.copy(os.path.join(args.results_root, "northstar.json"),
                        args.log_dir)
            tail = os.path.join(golden.OURS_ROOT, "LunarLander-v2",
                                "DQN_fast_1_seed.npy")
            if os.path.isfile(tail):
                _mirror(tail, args.log_dir, "LunarLander-v2")
    parity = [golden.check_against_jax(s) for s in golden.JAX_PARITY]
    golden.print_rows(parity)
    print(json.dumps({
        "jobs": [{k: j.get(k) for k in ("name", "card", "rc", "seconds")}
                 for j in jobs],
        "parity": [{k: r[k] for k in ("env", "algo", "status", "ours", "ref",
                                      "ours_seeds", "ref_seeds")}
                   for r in parity],
        "left_running": left}), flush=True)
    ok = (not left and all(j.get("rc") == 0 for j in jobs)
          and not any(r["status"] == "FAIL" for r in parity))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
