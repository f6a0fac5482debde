"""Rerun the JAX package's recipes on the CPU, as the reference from today's
JAX code for the port's parity rows held against ``jax_head``.

    python3 scripts/torch_jax_head.py ENV/STEM@jax_head [...] [--jobs 6]
        [--out results/torch/jax_head] [--work build/jax_head] [--force]

Each argument is a key (``golden.row_key``) of a row of
``golden.JAX_PARITY`` or ``golden.RUN_ONLY`` whose reference is
``jax_head``; a row that sweeps its runs (``then_sweep``) runs
``scripts/envelope_e2e.sweep(run_dir, None)`` on each seed's run dir after
its CLI command, in the same slot (never the JAX script's ``main()``), and
records both as one chained command. For each seed of the
row's recipe the JAX package's own CLI runs as a command,
``python -m freerl_tpu.cli <recipe> --results_root <work>/<env>
--no_tensorboard``, with ``JAX_PLATFORMS=cpu``, ``--jobs`` commands at once.
A seed's raw curve is kept as ``<out>/<env>/seeds/<label>_seed_<s>.npy``
(``golden.seed_file``), and a seed kept already (``golden.kept_seed``: its
file is there and its provenance says it ran the row's recipe) is not run
again unless ``--force`` asks; a kept file that another recipe made stops
the script. Then each row's seeds are stacked as
``<out>/<env>/<stem>.npy`` with ``golden.stack_curves`` (smoothed as the
JAX package's ``regenerate`` stacks them, or raw as
``scripts/r5_singles.py`` does, as the row says), and
``<out>/<env>/provenance.json`` records, for each seed, the command, the
commit, the JAX version, the device, the seconds and the env steps, and,
where the recipe takes ``--fixed_reset``, the start observation the JAX
package pins (``jax_starts``: the env the JAX CLI builds from the recipe,
reset once on the CPU); a kept fixed-reset seed whose record has no start,
or another start than the JAX package pins now, stops the script.

The script imports nothing of JAX and nothing of the JAX package; it exits
non-zero if a seed's command fails.
"""
from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from freerl_tpu_torch.train import golden  # noqa: E402


def head_row(key: str) -> golden.ParityRow:
    row = golden.recipe_row(key)
    if getattr(row, "ref", None) != "jax_head" or not row.regen:
        raise ValueError(f"{key}: not a jax_head row with a recipe")
    return row


def jax_argv(row: golden.ParityRow, seed: int, work: str) -> list:
    """The JAX CLI's command line for one seed of ``row``'s recipe."""
    return [sys.executable, "-m", "freerl_tpu.cli",
            *[a.format(seed=seed) for a in row.regen],
            "--results_root", os.path.join(work, row.env, f"seed_{seed}"),
            "--no_tensorboard"]


# scripts/envelope_e2e.py's sweep of one run dir, as
# scripts/envelope_seed_sweep.sh runs it after each seed's training (never
# the script's main(), whose curves go into results/learning_curves/)
SWEEP_CODE = ("import sys; sys.path.insert(0, '.'); "
              "from scripts.envelope_e2e import sweep; "
              "sweep(sys.argv[1], None)")


def sweep_argv(run_dir: str) -> list:
    """The command that sweeps one JAX run dir (``SWEEP_CODE``)."""
    return [sys.executable, "-c", SWEEP_CODE, run_dir]


def _git(*args) -> str | None:
    try:
        return subprocess.run(["git", *args], cwd=ROOT, capture_output=True,
                              text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def jax_version() -> str:
    out = subprocess.run([sys.executable, "-c",
                          "import jax; print(jax.__version__)"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


# run in a process of its own: the JAX CLI's argument parsing and env build
# (its ``build``, stopped before training), then one eager reset of the
# env, whose --fixed_reset wrapper pins the start whatever key it is given
_START_CODE = """
import json, sys
import jax
import freerl_tpu.cli as cli


class Built(Exception):
    pass


def build(args, _build=cli.build):
    raise Built(_build(args)[0])


cli.build = build
out = []
for argv in json.loads(sys.argv[1]):
    try:
        cli.run(argv)
    except Built as e:
        _, obs = e.args[0].reset(jax.random.PRNGKey(0))
        out.append([float(x) for x in jax.numpy.ravel(obs).tolist()])
print(json.dumps(out))
"""


def jax_starts(tasks: list) -> dict:
    """The start observation the JAX package pins for each ``(row, seed)``
    of ``tasks`` whose recipe takes ``--fixed_reset``, keyed by
    ``(row_key, seed)``, from one process on the CPU."""
    todo = [(row, seed) for row, seed in tasks
            if "--fixed_reset" in row.regen]
    if not todo:
        return {}
    argvs = [[a.format(seed=seed) for a in row.regen] for row, seed in todo]
    out = subprocess.run(
        [sys.executable, "-c", _START_CODE, json.dumps(argvs)], cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, check=True)
    starts = json.loads(out.stdout.strip().splitlines()[-1])
    return {(golden.row_key(row), seed): start
            for (row, seed), start in zip(todo, starts)}


def run_seeds(tasks: list, n_jobs: int, log_dir: str) -> list:
    """Run ``(row, seed, argv)`` tasks, ``n_jobs`` at once; a task of a
    ``then_sweep`` row sweeps its run dir (``sweep_argv``) in the same slot
    once its training ends well, into the same log. Returns one record per
    task (``rc``, ``seconds``, ``log``, and ``sweep``, the sweep's command,
    where one ran)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    pending, running, done = list(tasks), [], []
    while pending or running:
        while pending and len(running) < n_jobs:
            row, seed, argv = pending.pop(0)
            log = os.path.join(log_dir, f"{row.env}_{row.algo}_{seed}.log")
            f = open(log, "w")
            proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=f,
                                    stderr=subprocess.STDOUT)
            rec = dict(row=row, seed=seed, argv=argv, log=log)
            running.append((rec, proc, f, time.time()))
            print(f"[start] {row.env} {row.algo} seed {seed}", flush=True)
        for item in list(running):
            rec, proc, f, t0 = item
            if proc.poll() is None:
                continue
            f.close()
            running.remove(item)
            if (proc.returncode == 0 and rec["row"].then_sweep
                    and "sweep" not in rec):
                with open(rec["log"]) as lf:
                    run_dir = golden.parse_run_log(lf.read())["run_dir"]
                rec["sweep"] = sweep_argv(run_dir)
                f = open(rec["log"], "a")
                running.append((rec, subprocess.Popen(
                    rec["sweep"], cwd=ROOT, env=env, stdout=f,
                    stderr=subprocess.STDOUT), f, t0))
                continue
            rec.update(rc=proc.returncode, seconds=round(time.time() - t0, 1))
            done.append(rec)
            print(f"[end] {rec['row'].env} {rec['row'].algo} seed "
                  f"{rec['seed']}: rc {rec['rc']} in {rec['seconds']} s",
                  flush=True)
        time.sleep(1.0)
    return done


def _command(argv: list) -> str:
    """A recorded command: ``argv`` with the interpreter as ``python`` and
    paths under the repo relative to it."""
    return shlex.join(["python", *[os.path.relpath(a, ROOT)
                                   if a.startswith(ROOT) else a
                                   for a in argv[1:]]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("rows", nargs="+", help="ENV/STEM@jax_head row keys")
    ap.add_argument("--jobs", type=int, default=6,
                    help="JAX CLI commands at once")
    ap.add_argument("--out", default=golden.JAX_HEAD_ROOT)
    ap.add_argument("--work", default=os.path.join(ROOT, "build",
                                                   "jax_head"))
    ap.add_argument("--force", action="store_true",
                    help="rerun seeds whose curve is kept already")
    args = ap.parse_args(argv)
    rows = [head_row(k) for k in args.rows]
    os.makedirs(args.work, exist_ok=True)
    starts = jax_starts([(row, seed) for row in rows
                         for seed in row.regen_seeds])
    tasks, seen, shared = [], set(), {}
    for row in rows:
        for seed in row.regen_seeds:
            path = golden.seed_file(args.out, row, seed)
            start = starts.get((golden.row_key(row), seed))
            if path in seen or (not args.force and golden.kept_seed(
                    args.out, row, seed, start)):
                continue
            seen.add(path)
            argv = jax_argv(row, seed, args.work)
            # rows of one recipe that is swept share each seed's run
            if row.then_sweep and tuple(argv) in shared:
                shared[tuple(argv)].append(row)
                continue
            shared[tuple(argv)] = [row]
            tasks.append((row, seed, argv))
    commit = _git("rev-parse", "HEAD")
    clean = _git("status", "--porcelain", "--", "freerl_tpu") == ""
    version = jax_version()
    records = run_seeds(tasks, args.jobs, args.work)
    failed = []
    for rec in records:
        seed = rec["seed"]
        if rec["rc"] != 0:
            failed.append(f"{golden.row_key(rec['row'])}:{seed}")
            continue
        with open(rec["log"]) as f:
            info = golden.parse_run_log(f.read())
        command = "JAX_PLATFORMS=cpu " + _command(rec["argv"])
        swept = {}
        if "sweep" in rec:
            command += " && " + _command(rec["sweep"])
            with open(os.path.join(info["run_dir"],
                                   "sweep_summary.json")) as f:
                swept = dict(sweep=json.load(f))
        for row in shared[tuple(rec["argv"])]:
            curve = golden.seed_curve(row, info["run_dir"], seed)
            path = golden.seed_file(args.out, row, seed)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, curve)
            golden.update_provenance(args.out, row.env, seeds={
                os.path.basename(path): dict(
                    command=command, commit=commit, freerl_tpu_clean=clean,
                    jax=version, device="cpu", seconds=rec["seconds"],
                    env_steps=info["env_steps"], episodes=info["episodes"],
                    steps_per_s=info["steps_per_s"],
                    final50=round(float(curve[-50:].mean()), 4), **swept,
                    **({} if (golden.row_key(row), seed) not in starts else
                       {"start": starts[(golden.row_key(row), seed)]}))})
    for row in rows:
        if not all(golden.kept_seed(args.out, row, s, starts.get(
                (golden.row_key(row), s))) for s in row.regen_seeds):
            print(f"[stack] {golden.row_key(row)}: seeds missing; not "
                  f"stacked", flush=True)
            continue
        paths = [golden.seed_file(args.out, row, s) for s in row.regen_seeds]
        out = golden.stack_curves(row, [np.load(p) for p in paths],
                                  os.path.join(args.out, row.env))
        golden.update_provenance(args.out, row.env,
                                 stacks=golden.stack_record(row))
        stack = np.load(out)
        print(json.dumps({"stack": golden.row_key(row),
                          "shape": list(stack.shape),
                          "final50": [round(float(x), 2) for x in
                                      stack[:, -50:].mean(1)]}), flush=True)
    if failed:
        print("FAILED:", failed, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
