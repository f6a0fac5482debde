"""Train the port's learning-curve rows on the card and hold them against
the JAX curves each row names.

    python3 scripts/torch_golden_card.py [--northstar 4096x8] [ROW ...]
        [--device cuda|cpu] [--per_card K] [--force] [--seeds S ...]
        [--total_steps 150000000] [--deadline SECONDS]
        [--results_root results/torch] [--log_dir build/golden_card]

The jobs: the north-star point (``scripts/torch_northstar.py`` at
``--northstar``, seed 0) and, for each ROW of ``golden.JAX_PARITY`` or
``golden.RUN_ONLY`` (a ``golden.row_key``: ``ENV/STEM``, or
``ENV/STEM@jax_head``), one run of the row's recipe per seed through the
port's CLI (``golden.regen_argv``, as ``golden.regenerate`` runs it; a row
that sweeps its runs, ``then_sweep``, through ``SWEEP_RUNNER``, one job a
seed for every row of its recipe; a row whose recipe is a script's argv,
``script``, through the port's ``scripts/torch_<script>.py``, which keeps
the seed's curve and record itself); ``--seeds`` runs only those of a row's
seeds, in the order given (a queue longest first), so a long row can be
spread over several calls. A seed whose raw
curve is kept under ``golden.OURS_ROOT`` (``golden.kept_seed``: its file is
there and its provenance says it ran the row's recipe, from the start the
port pins now where the recipe takes ``--fixed_reset``) is not run again,
and its kept curve is stacked, unless ``--force`` asks to run it again; a
kept file that another recipe made, or that ran from another start, stops
the script. Each job is a process of its own. On the
card each process sees one card (``CUDA_VISIBLE_DEVICES``): the jobs are
dealt to the cards in turn, and a card runs ``--per_card`` of its jobs at
once and starts the next as one ends, so four cards at ``--per_card 1``
run the north star and three seeds at once. ``--device cpu`` runs
``--per_card`` jobs at once on the CPU.

Each seed that finishes keeps its raw curve under ``golden.OURS_ROOT``
(``golden.seed_file``), and how it was made in the env's
``provenance.json`` (under ``--fixed_reset`` with the start observation it
pinned, ``golden.pinned_start``); when every seed of a row is kept, the
seeds are stacked with ``golden.save_stack`` under ``golden.OURS_ROOT`` and
the stack is printed as one JSON line. The north-star job writes
``<results_root>/northstar.json`` and its tail curve under
``golden.OURS_ROOT``. Each job's output goes to ``<log_dir>/<job>.log``;
``northstar.json`` is copied into ``--log_dir``, and the kept curves, the
stacks and the provenance into ``<log_dir>/curves/``, laid out as
``golden.OURS_ROOT``. Then the parity gate (``golden.check_against_jax``)
runs over ``golden.JAX_PARITY``, and a last JSON line gives each job and
each row.

At ``--deadline`` seconds the jobs still running are stopped and read as
cut; their rows stay absent (``missing``). No child outlives the script. It
exits non-zero if a job failed or was cut, or a row fails its gate that is
not held to fail (``golden.breaks_hold``). It runs on the card; without one
it exits non-zero unless ``--device cpu`` asks for the CPU.

``probe`` is the shims' ``--probe`` (``scripts/torch_r5_marl_n5.py``,
``scripts/torch_train_spread.py``): each passes its own table and argv.
"""
from __future__ import annotations

import argparse
import json
import os
import shlex
import shutil
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import card_line  # noqa: E402
from freerl_tpu_torch.train import golden  # noqa: E402

NORTHSTAR = "LunarLander-v2/DQN_fast_1_seed"
# where a probe's run dirs go: git-ignored and out of any log dir, since an
# off-policy run dir's checkpoint holds its whole replay ring
PROBE_RUNS_ROOT = os.path.join(ROOT, "results", "torch", "golden_runs",
                               "probe")
# how a seed of a ``then_sweep`` row runs: the port's CLI, then the sweep of
# its run dir, in one process
SWEEP_RUNNER = ["-m", "scripts.torch_envelope_e2e", "--and_sweep"]


def parity_row(key: str) -> golden.GoldenSpec:
    return golden.recipe_row(key)


def make_jobs(northstar, keys, total_steps, device, results_root,
              reuse: bool = False, seeds=None) -> list:
    """One dict per process: its name, argv, and the row it feeds, one
    per seed file (rows of one recipe share their seeds' files). With
    ``reuse``, no job for a seed of the row's recipe that is kept
    (``golden.kept_seed``); with ``seeds``, none for a seed not in it, and
    the row's jobs in its order (a queue longest first)."""
    jobs, made = [], set()
    if northstar:
        jobs.append(dict(
            name=f"northstar_{northstar}", row=NORTHSTAR, argv=[
                sys.executable, os.path.join(ROOT, "scripts",
                                             "torch_northstar.py"),
                "--points", northstar, "--total_steps", str(total_steps),
                "--seed", "0", "--device", device,
                "--out", os.path.join(results_root, "northstar.json"),
                "--curves_root", golden.OURS_ROOT]))
    swept = {}
    for key in keys:
        spec = parity_row(key)
        if not spec.regen:
            raise ValueError(f"{key} has no recipe: the north star runs "
                             f"through --northstar")
        script = getattr(spec, "script", "")
        for seed in (spec.regen_seeds if seeds is None else
                     [s for s in seeds if s in spec.regen_seeds]):
            path = golden.seed_file(golden.OURS_ROOT, spec, seed)
            if path in made or (reuse and golden.kept_seed(
                    golden.OURS_ROOT, spec, seed)):
                continue
            made.add(path)
            if script:
                # a recipe that is no CLI argv: the port's script of it
                # runs the seed and keeps its curve and record itself
                jobs.append(dict(
                    name=f"{spec.env}_{spec.algo}_seed_{seed}", row=key,
                    also=[], seed=seed, script=script, argv=[
                        sys.executable, "-m", f"scripts.torch_{script}",
                        *[a.format(seed=seed) for a in spec.regen],
                        "--device", device]))
                continue
            argv = golden.regen_argv(spec, seed, results_root, device)
            sweep = getattr(spec, "then_sweep", False)
            # the rows of a swept recipe share each seed's run
            if sweep and tuple(argv) in swept:
                swept[tuple(argv)]["also"].append(key)
                continue
            runner = SWEEP_RUNNER if sweep else ["-m", "freerl_tpu_torch.cli"]
            jobs.append(dict(
                name=f"{spec.env}_{spec.algo}_seed_{seed}", row=key,
                also=[], seed=seed, argv=[sys.executable, *runner, *argv]))
            if sweep:
                swept[tuple(argv)] = jobs[-1]
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
             deadline: float | None, per_card: int = 1) -> None:
    """Run the jobs, dealt to the cards in turn, ``per_card`` processes a
    card at a time: a card starts its next job as one of its own ends.
    Fill each job's ``rc`` (None: cut at the deadline or never started),
    ``card``, ``seconds`` and ``log``."""
    n_cards = torch.cuda.device_count() if device == "cuda" else 1
    queues = deal(jobs, n_cards)
    running = []                    # (card, job, Popen, file, t0)
    t_start = time.time()
    try:
        while any(queues) or running:
            for card in range(n_cards):
                while queues[card] and sum(
                        r[0] == card for r in running) < per_card:
                    job = queues[card].pop(0)
                    env = dict(os.environ)
                    if device == "cuda":
                        env["CUDA_VISIBLE_DEVICES"] = str(card)
                    job.update(card=card if device == "cuda" else None,
                               log=os.path.join(log_dir,
                                                job["name"] + ".log"))
                    f = open(job["log"], "w")
                    proc = subprocess.Popen(
                        job["argv"], cwd=ROOT, env=env, stdout=f,
                        stderr=subprocess.STDOUT, start_new_session=True)
                    running.append((card, job, proc, f, time.time()))
                    where = f"card {card}" if device == "cuda" else "cpu"
                    print(f"[start] {job['name']} on {where}", flush=True)
            for item in list(running):
                _, job, proc, f, t0 = item
                if proc.poll() is None:
                    continue
                f.close()
                job.update(rc=proc.returncode,
                           seconds=round(time.time() - t0, 1))
                running.remove(item)
                print(f"[end] {job['name']}: rc {job['rc']} in "
                      f"{job['seconds']} s", flush=True)
            if deadline is not None and time.time() - t_start > deadline:
                print(f"[deadline] {deadline} s: stopping "
                      f"{[r[1]['name'] for r in running]}", flush=True)
                break
            time.sleep(1.0)
    finally:
        for _, job, proc, f, t0 in running:
            _stop(proc)
            f.close()
            job.update(rc=None, seconds=round(time.time() - t0, 1))


def _keep(path: str, log_dir: str) -> None:
    """Copy a file under ``golden.OURS_ROOT`` to the same place under
    ``<log_dir>/curves/``."""
    rel = os.path.relpath(path, golden.OURS_ROOT)
    dst = os.path.join(log_dir, "curves", rel)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    shutil.copy(path, dst)


def keep_seeds(jobs: list, log_dir: str) -> None:
    """Keep the raw curve of every seed that finished under
    ``golden.OURS_ROOT`` (``golden.seed_file``), also where its row is not
    complete, with how it was made in the env's ``provenance.json``, and
    copy them into ``log_dir``."""
    for j in jobs:
        if "seed" not in j or j.get("rc") != 0:
            continue
        if "script" in j:
            spec = parity_row(j["row"])
            for path in (golden.seed_file(golden.OURS_ROOT, spec, j["seed"]),
                         os.path.join(golden.OURS_ROOT, spec.env,
                                      "provenance.json")):
                _keep(path, log_dir)
            continue
        with open(j["log"]) as f:
            info = golden.parse_run_log(f.read())
        run_dir = info.pop("run_dir")
        summary = os.path.join(run_dir, "sweep_summary.json")
        if os.path.isfile(summary):
            with open(summary) as f:
                info["sweep"] = json.load(f)
        for key in [j["row"], *j.get("also", [])]:
            spec = parity_row(key)
            curve = golden.seed_curve(spec, run_dir, j["seed"])
            kept = golden.seed_file(golden.OURS_ROOT, spec, j["seed"])
            pinned = golden.pinned_start(spec, j["seed"])
            start = {} if pinned is None else dict(start=pinned)
            os.makedirs(os.path.dirname(kept), exist_ok=True)
            np.save(kept, curve)
            prov = golden.update_provenance(
                golden.OURS_ROOT, spec.env, seeds={
                    os.path.basename(kept): dict(
                        command=shlex.join(["python", *[
                            os.path.relpath(a, ROOT) if a.startswith(ROOT)
                            else a for a in j["argv"][1:]]]),
                        card=None if j["card"] is None else card_line(),
                        seconds=j["seconds"], **info, **start,
                        final50=round(float(curve[-50:].mean()), 4))})
            for path in (kept, prov):
                _keep(path, log_dir)


def stack_rows(keys: list, jobs: list, log_dir: str) -> None:
    """Stack the kept seeds of every recipe row whose jobs all finished and
    whose seeds are all kept (``golden.kept_seed``), print each stack as
    one JSON line, and copy it into ``log_dir``."""
    for key in dict.fromkeys(keys):
        spec = parity_row(key)
        paths = [golden.seed_file(golden.OURS_ROOT, spec, seed)
                 for seed in spec.regen_seeds]
        if (any(j.get("rc") != 0 for j in jobs
                if key in (j["row"], *j.get("also", [])))
                or not all(golden.kept_seed(golden.OURS_ROOT, spec, seed)
                           for seed in spec.regen_seeds)):
            print(f"[stack] {key}: not every seed finished; not stacked",
                  flush=True)
            continue
        curves = [np.load(p) for p in paths]
        golden.save_stack(spec, curves)
        path = os.path.join(golden.OURS_ROOT, spec.env, spec.algo + ".npy")
        prov = golden.update_provenance(golden.OURS_ROOT, spec.env,
                                        stacks=golden.stack_record(spec))
        for p in (path, prov):
            _keep(p, log_dir)
        stack = np.load(path)
        print(json.dumps({
            "stack": key, "shape": list(stack.shape),
            "seeds": list(spec.regen_seeds),
            "episodes": [len(c) for c in curves],
            f"final{spec.window}": [round(float(x), 2) for x in
                                    stack[:, -spec.window:].mean(1)],
            "returns": [[round(float(x), 2) for x in s] for s in stack]}),
            flush=True)


def probe_jobs(tags, episodes: int, device: str, runs_root: str,
               argv_of) -> list:
    """One job a tag: seed 0 of its argv (``argv_of(tag, seed,
    results_root)``, a shim's recipe) for ``episodes`` episodes."""
    jobs = []
    for tag in tags:
        argv = argv_of(tag, 0, results_root=runs_root)
        argv[argv.index("--max_episodes") + 1] = str(episodes)
        jobs.append(dict(name=f"probe_{tag}", row=tag, argv=[
            sys.executable, "-m", "freerl_tpu_torch.cli", *argv,
            "--device", device]))
    return jobs


def probe_record(job: dict, runs: dict) -> dict:
    """What one probe job's log says of its speed, and the seconds a seed of
    the tag's full recipe (its episodes, ``runs[tag][2]``) projects."""
    out = dict(tag=job["row"], rc=job.get("rc"), seconds=job.get("seconds"))
    if job.get("rc") != 0:
        return out
    with open(job["log"]) as f:
        info = golden.parse_run_log(f.read())
    loop_s = info["env_steps"] / max(info["steps_per_s"], 1)
    per_episode = loop_s / info["episodes"]
    full = runs[job["row"]][2]
    out.update(episodes=info["episodes"], env_steps=info["env_steps"],
               b1_launches=info.get("b1_launches"),
               loop_s=round(loop_s, 2), s_per_episode=round(per_episode, 5),
               projected_s_a_seed=round(
                   per_episode * full + job["seconds"] - loop_s, 1))
    return out


def probe(tags, episodes: int, argv, argv_of, runs: dict,
          log_dir: str, project=None) -> int:
    """A shim's ``--probe EPISODES``: seed 0 of each tag of ``runs`` (the
    shim's table, its argv ``argv_of``) for ``episodes`` episodes, with the
    options in ``argv`` (``--per_card``, ``--device``, ``--deadline``,
    ``--log_dir``, by default ``log_dir``, and ``--runs_root``, by default
    ``PROBE_RUNS_ROOT``). Prints a record a tag (with ``project(record)``
    under ``projections`` where the shim gives it and the tag's run ended
    well) and the card's line."""
    pa = argparse.ArgumentParser()
    pa.add_argument("--per_card", type=int, default=1)
    pa.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    pa.add_argument("--deadline", type=float, default=None)
    pa.add_argument("--log_dir", default=log_dir)
    pa.add_argument("--runs_root", default=PROBE_RUNS_ROOT)
    p = pa.parse_args(argv)
    from chip_smoke import stop_children

    os.makedirs(p.log_dir, exist_ok=True)
    jobs = probe_jobs(tags, episodes, p.device, p.runs_root, argv_of)
    try:
        run_jobs(jobs, p.device, p.log_dir, p.deadline, p.per_card)
    finally:
        left = stop_children()
    for j in jobs:
        rec = probe_record(j, runs)
        if project is not None and rec["rc"] == 0:
            rec["projections"] = project(rec)
        print(json.dumps(rec), flush=True)
    print(json.dumps({"per_card": p.per_card, "device": p.device,
                      "card": card_line() if p.device == "cuda" else None,
                      "left_running": left}), flush=True)
    return 0 if not left and all(j.get("rc") == 0 for j in jobs) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("rows", nargs="*",
                    help="rows of golden.JAX_PARITY or RUN_ONLY with a "
                         "recipe, by "
                         "golden.row_key (ENV/STEM[@REF])")
    ap.add_argument("--northstar", default=None,
                    help="the north-star point NUM_ENVSxUPB, e.g. 4096x8")
    ap.add_argument("--per_card", type=int, default=1,
                    help="jobs a card (or, with --device cpu, the CPU) "
                         "runs at once")
    ap.add_argument("--force", action="store_true",
                    help="run seeds again whose curve is kept already")
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="run only these seeds of each row, in this "
                         "order (default: all)")
    ap.add_argument("--total_steps", type=int, default=150_000_000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--deadline", type=float, default=None,
                    help="seconds after which running jobs are stopped")
    ap.add_argument("--results_root",
                    default=os.path.join(ROOT, "results", "torch"))
    ap.add_argument("--log_dir",
                    default=os.path.join(ROOT, "build", "golden_card"))
    # rows may come on either side of the options (the shims put theirs
    # first and hand on the caller's arguments after them)
    args = ap.parse_intermixed_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_golden_card: no CUDA card; pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        return 1
    jobs = make_jobs(args.northstar, args.rows, args.total_steps,
                     args.device, args.results_root, not args.force,
                     args.seeds)
    os.makedirs(args.log_dir, exist_ok=True)
    from chip_smoke import stop_children

    try:
        run_jobs(jobs, args.device, args.log_dir, args.deadline,
                 args.per_card)
        keep_seeds(jobs, args.log_dir)
        stack_rows(args.rows, jobs, args.log_dir)
    finally:
        left = stop_children()
    for j in jobs:
        if j["row"] == NORTHSTAR and j.get("rc") == 0:
            shutil.copy(os.path.join(args.results_root, "northstar.json"),
                        args.log_dir)
            tail = os.path.join(golden.OURS_ROOT, "LunarLander-v2",
                                "DQN_fast_1_seed.npy")
            if os.path.isfile(tail):
                _keep(tail, args.log_dir)
    keys = [golden.row_key(s) for s in golden.JAX_PARITY]
    parity = [golden.check_against_jax(s) for s in golden.JAX_PARITY]
    golden.print_rows(parity, keys)
    print(json.dumps({
        "jobs": [{k: j.get(k) for k in ("name", "card", "rc", "seconds")}
                 for j in jobs],
        "parity": [{"key": key, **{k: r[k] for k in (
            "env", "algo", "status", "ours", "ref", "ours_seeds",
            "ref_seeds")}} for key, r in zip(keys, parity)],
        "left_running": left}), flush=True)
    ok = (not left and all(j.get("rc") == 0 for j in jobs)
          and not any(r["status"] == "FAIL"
                      and golden.breaks_hold(key, "FAIL")
                      for key, r in zip(keys, parity)))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
