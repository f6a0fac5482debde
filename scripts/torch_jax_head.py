"""Rerun the JAX package's recipes on the CPU, as the reference from today's
JAX code for the port's parity rows held against ``jax_head``.

    python3 scripts/torch_jax_head.py ENV/STEM@jax_head [...] [--jobs 6]
        [--out results/torch/jax_head] [--work build/jax_head] [--force]

``--gail SEED ...`` runs the JAX package's scripts/gail_e2e.py at its
defaults on the CPU for each seed instead (``run_gail``) and keeps each
seed's summary, eval returns and curves under
``<out>/gail/Pendulum-v1/GAIL_seed_<s>/``, with its record in
``<out>/gail/Pendulum-v1/provenance.json``.

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

A row whose recipe is a script's argv (``script``: scripts/pixel_curve.py)
runs the JAX package's own script, ``python -m scripts.<script> --cpu
<recipe>``, in a directory of its own under ``--work`` (``script_dir``):
the script saves its curve under its working directory's
``results/learning_curves/``, which must not be the repo's. The kept
seed's record has the counts the script prints. ``--one_thread`` runs
each command with XLA on one CPU thread (``ONE_THREAD``, recorded as
``xla_flags``); ``--deadline`` stops the commands still running after that
many seconds, keeps the seeds that finished and reads the others as
failed; ``--seeds`` runs only those of each row's seeds.

The script imports nothing of JAX and nothing of the JAX package; it exits
non-zero if a seed's command fails or is stopped.
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
    """The JAX CLI's command line for one seed of ``row``'s recipe; for a
    row whose recipe is a script's argv (``script``), the JAX package's
    script on the CPU (``--cpu``)."""
    if getattr(row, "script", ""):
        return [sys.executable, "-m", f"scripts.{row.script}", "--cpu",
                *[a.format(seed=seed) for a in row.regen]]
    return [sys.executable, "-m", "freerl_tpu.cli",
            *[a.format(seed=seed) for a in row.regen],
            "--results_root", os.path.join(work, row.env, f"seed_{seed}"),
            "--no_tensorboard"]


# XLA on one CPU thread a process: several JAX commands then share the
# cores without each spawning a thread pool of its own
ONE_THREAD = ("--xla_cpu_multi_thread_eigen=false "
              "intra_op_parallelism_threads=1")

# scripts/envelope_e2e.py's sweep of one run dir, as
# scripts/envelope_seed_sweep.sh runs it after each seed's training (never
# the script's main(), whose curves go into results/learning_curves/)
SWEEP_CODE = ("import sys; sys.path.insert(0, '.'); "
              "from scripts.envelope_e2e import sweep; "
              "sweep(sys.argv[1], None)")


def sweep_argv(run_dir: str) -> list:
    """The command that sweeps one JAX run dir (``SWEEP_CODE``)."""
    return [sys.executable, "-c", SWEEP_CODE, run_dir]


def script_dir(work: str, row: golden.ParityRow, seed: int) -> str:
    """The working directory of one seed of a ``script`` row: the JAX
    script writes its curve relative to it
    (``results/learning_curves/<env>/``; scripts/pixel_curve.py:48-50), so
    it must not be the repo's root, whose committed curves it would
    overwrite."""
    return os.path.join(work, row.env, f"{row.script}_seed_{seed}")


def script_curve(row: golden.ParityRow, seed: int, cwd: str) -> str:
    """Where a ``script`` row's JAX script saved one seed's curve."""
    return os.path.join(cwd, "results", "learning_curves", row.env,
                        f"{golden._label(row)}_seed_{seed}.npy")


def parse_script_log(text: str) -> dict:
    """The counts of the loop's ``info`` dict that a JAX script prints
    (``info: {...}``)."""
    import re

    out = {}
    for key in ("env_steps", "updates", "episodes"):
        m = re.search(rf"'{key}': (\d+)", text)
        if m is not None:
            out[key] = int(m.group(1))
    m = re.search(r"'elapsed_s': ([0-9.e+-]+)", text)
    if m is not None:
        out["loop_s"] = round(float(m.group(1)), 1)
    return out


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


def run_seeds(tasks: list, n_jobs: int, log_dir: str,
              xla_flags: str | None = None,
              deadline: float | None = None) -> list:
    """Run ``(row, seed, argv)`` tasks, ``n_jobs`` at once, with
    ``XLA_FLAGS`` set to ``xla_flags`` where given; a task of a
    ``then_sweep`` row sweeps its run dir (``sweep_argv``) in the same slot
    once its training ends well, into the same log; a task of a ``script``
    row runs in its ``script_dir`` under ``log_dir``, with the repo on
    ``PYTHONPATH``. At ``deadline`` seconds the tasks still running are
    stopped (``rc`` None) and those not started are dropped. Returns one
    record per task (``rc``, ``seconds``, ``log``, ``cwd``, and ``sweep``,
    the sweep's command, where one ran)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if xla_flags is not None:
        env["XLA_FLAGS"] = xla_flags
    pending, running, done = list(tasks), [], []
    t_start = time.time()
    while pending or running:
        if deadline is not None and time.time() - t_start > deadline:
            for rec, proc, f, t0 in running:
                proc.kill()
                proc.wait()
                f.close()
                rec.update(rc=None, seconds=round(time.time() - t0, 1))
                done.append(rec)
                print(f"[deadline] {rec['row'].env} {rec['row'].algo} seed "
                      f"{rec['seed']} stopped after {rec['seconds']} s",
                      flush=True)
            break
        while pending and len(running) < n_jobs:
            row, seed, argv = pending.pop(0)
            log = os.path.join(log_dir, f"{row.env}_{row.algo}_{seed}.log")
            cwd, task_env = ROOT, env
            if getattr(row, "script", ""):
                cwd = script_dir(log_dir, row, seed)
                os.makedirs(cwd, exist_ok=True)
                task_env = dict(env, PYTHONPATH=ROOT)
            f = open(log, "w")
            proc = subprocess.Popen(argv, cwd=cwd, env=task_env, stdout=f,
                                    stderr=subprocess.STDOUT)
            rec = dict(row=row, seed=seed, argv=argv, log=log, cwd=cwd)
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


# scripts/gail_e2e.py's artifacts of one run that are kept for a seed (the
# expert set and the config, which names the run's own paths, are not)
GAIL_KEPT = ("summary.json", "eval_rewards.npz", "expert_curve.npy",
             "gail_true_reward_curve.npy")


def gail_dir(root: str, seed: int) -> str:
    """Where one seed of scripts/gail_e2e.py is kept under ``root``."""
    return os.path.join(root, "gail", "Pendulum-v1", f"GAIL_seed_{seed}")


def run_gail(seeds: list, n_jobs: int, out: str, work: str,
             xla_flags: str | None, force: bool = False) -> list:
    """scripts/gail_e2e.py at its defaults on the CPU, one command a seed,
    ``n_jobs`` at once, each writing its run dir under ``<work>/gail``;
    keeps each finished seed's ``GAIL_KEPT`` under ``gail_dir(out, seed)``
    and its record (the command, the commit, the JAX version, the device,
    the XLA flags, the seconds and the two evaluations) in
    ``<out>/gail/Pendulum-v1/provenance.json``. A seed kept already is not
    run again unless ``force``. Returns the seeds whose command failed."""
    import glob
    import shutil

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if xla_flags is not None:
        env["XLA_FLAGS"] = xla_flags
    todo = [s for s in seeds if force or not os.path.isfile(
        os.path.join(gail_dir(out, s), "summary.json"))]
    commit = _git("rev-parse", "HEAD")
    clean = _git("status", "--porcelain", "--", "freerl_tpu") == ""
    version = jax_version()
    running, failed = [], []
    while todo or running:
        while todo and len(running) < n_jobs:
            seed = todo.pop(0)
            run_out = os.path.join(work, "gail", f"seed_{seed}")
            argv = [sys.executable, "-m", "scripts.gail_e2e", "--cpu",
                    "--seed", str(seed), "--out", run_out]
            os.makedirs(run_out, exist_ok=True)
            f = open(os.path.join(run_out, "log.txt"), "w")
            running.append((seed, argv, run_out, subprocess.Popen(
                argv, cwd=ROOT, env=env, stdout=f,
                stderr=subprocess.STDOUT), f, time.time()))
            print(f"[start] gail_e2e seed {seed}", flush=True)
        for item in list(running):
            seed, argv, run_out, proc, f, t0 = item
            if proc.poll() is None:
                continue
            f.close()
            running.remove(item)
            seconds = round(time.time() - t0, 1)
            print(f"[end] gail_e2e seed {seed}: rc {proc.returncode} in "
                  f"{seconds} s", flush=True)
            if proc.returncode != 0:
                failed.append(seed)
                continue
            run_dir = sorted(glob.glob(os.path.join(
                run_out, "Pendulum-v1", "GAIL", "*", "summary.json")))[-1]
            run_dir = os.path.dirname(run_dir)
            keep = gail_dir(out, seed)
            os.makedirs(keep, exist_ok=True)
            for name in GAIL_KEPT:
                shutil.copy(os.path.join(run_dir, name), keep)
            with open(os.path.join(keep, "summary.json")) as sf:
                summary = json.load(sf)
            command = "JAX_PLATFORMS=cpu " + _command(
                argv[:-1] + ["<work>/gail/seed_" + str(seed)])
            if xla_flags is not None:
                command = f"XLA_FLAGS={shlex.quote(xla_flags)} " + command
            golden.update_provenance(
                os.path.join(out, "gail"), "Pendulum-v1", seeds={
                    os.path.basename(keep): dict(
                        command=command, commit=commit,
                        freerl_tpu_clean=clean, jax=version, device="cpu",
                        xla_flags=xla_flags, seconds=seconds, **{
                            k: summary[k] for k in ("expert_eval_avg",
                                                    "gail_eval_avg")})})
        time.sleep(1.0)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("rows", nargs="*", help="ENV/STEM@jax_head row keys")
    ap.add_argument("--gail", type=int, nargs="+", default=None,
                    metavar="SEED", help="run scripts/gail_e2e.py for these "
                    "seeds (``run_gail``) in place of rows")
    ap.add_argument("--jobs", type=int, default=6,
                    help="JAX CLI commands at once")
    ap.add_argument("--out", default=golden.JAX_HEAD_ROOT)
    ap.add_argument("--work", default=os.path.join(ROOT, "build",
                                                   "jax_head"))
    ap.add_argument("--force", action="store_true",
                    help="rerun seeds whose curve is kept already")
    ap.add_argument("--one_thread", action="store_true",
                    help="XLA on one CPU thread a command (ONE_THREAD)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="seconds after which running commands are stopped")
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="run only these of each row's seeds, in the row's "
                         "order (default: all)")
    args = ap.parse_args(argv)
    xla_flags = ONE_THREAD if args.one_thread else None
    if args.gail is not None:
        failed = run_gail(args.gail, args.jobs, args.out, args.work,
                          xla_flags, args.force)
        if failed:
            print("FAILED:", failed, flush=True)
        return 1 if failed else 0
    rows = [head_row(k) for k in args.rows]
    os.makedirs(args.work, exist_ok=True)
    starts = jax_starts([(row, seed) for row in rows
                         for seed in row.regen_seeds])
    tasks, seen, shared = [], set(), {}
    for row in rows:
        for seed in row.regen_seeds:
            if args.seeds is not None and seed not in args.seeds:
                continue
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
    records = run_seeds(tasks, args.jobs, args.work, xla_flags,
                        args.deadline)
    failed = []
    for rec in records:
        seed = rec["seed"]
        if rec["rc"] != 0:
            failed.append(f"{golden.row_key(rec['row'])}:{seed}")
            continue
        with open(rec["log"]) as f:
            text = f.read()
        command = "JAX_PLATFORMS=cpu " + _command(rec["argv"])
        if xla_flags is not None:
            command = f"XLA_FLAGS={shlex.quote(xla_flags)} " + command
        if getattr(rec["row"], "script", ""):
            row = rec["row"]
            curve = np.load(script_curve(row, seed, rec["cwd"]))
            path = golden.seed_file(args.out, row, seed)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, curve)
            golden.update_provenance(args.out, row.env, seeds={
                os.path.basename(path): dict(
                    command="PYTHONPATH=. " + command, commit=commit,
                    freerl_tpu_clean=clean, jax=version, device="cpu",
                    xla_flags=xla_flags, seconds=rec["seconds"],
                    **parse_script_log(text),
                    final50=round(float(curve[-50:].mean()), 4))})
            continue
        info = golden.parse_run_log(text)
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
