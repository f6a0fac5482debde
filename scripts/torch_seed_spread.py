"""The seed spread of one recipe in the port and in the JAX package, from
the two trees' curves (numpy and scipy only).

    python3 scripts/torch_seed_spread.py [--env LunarLander-v2]
        [--stem DQN_16_seed] [--ours results/torch/learning_curves]
        [--ref results/torch/jax_head] [--below X]
    python3 scripts/torch_seed_spread.py --committed --env BipedalWalker-v3
        --stem CEM_GD3PG_4_seed
    python3 scripts/torch_seed_spread.py --greedy results/torch/c12_greedy.json

Each side's ``<root>/<env>/provenance.json`` names, under ``stacks``, the
seeds of ``<stem>`` and their raw curves (``<root>/<env>/seeds/``), and,
under ``seeds``, each run's env steps; ``<root>/<env>/<stem>.npy`` is the
stack the gate reads (smoothed with alpha 0.9). The script prints one JSON
line: for each side the seeds, the per-seed final-50 of the stack and of
the raw curves, their mean, the break-out share (seeds whose stacked
final-50 is at least ``BREAKOUT``, 100), the env steps each run took to its
500th episode (the run stops at the first chunk past it) and the mean raw
return of episodes 10-40 (0-based, ``curve[10:41]``); the two-sided
Mann-Whitney U test (``scipy.stats.mannwhitneyu``) of the two sides'
stacked final-50s, of their raw final-50s and of their episode-10-40
means; and Fisher's exact two-sided test (``scipy.stats.fisher_exact``) of
the two sides' break-out counts. With ``--below X`` each side also counts
the seeds whose stacked final-50 is below X (``below``: C13's seeds on the
second policy, X = -180 on Pendulum), and ``fisher_below`` tests those
counts.

``--greedy`` reads the greedy success rates ``scripts/torch_c12_greedy.py``
wrote and prints C12's rule over them (``greedy_rule``): the two-sided
Mann-Whitney p of the per-seed rates, each side's best rate, and whether
both parts hold (p >= 0.05, and the port's best at least JAX's best less
the row's slack, 0.08).

``--committed`` compares the port's stack ``<ours>/<env>/<stem>.npy``
with the JAX package's committed stack of the same stem
(``results/learning_curves/<env>/<stem>.npy``), both raw, one row a draw:
each row's final-50 mean (``WINDOW``), both sides' means and the two-sided
Mann-Whitney p (the CEM-GD3PG walker row, whose JAX draws have no
``@jax_head`` counterpart yet).

``--gail`` prints C20's rule over the GAIL runs each side keeps
(``gail_rule``): every run under ``--gail_ours`` (``results/torch/gail``:
the port's ``scripts/torch_gail_e2e.py`` runs, each dir's ``config.json``
naming its seed, or a ``GAIL_seed_<s>`` dir) and under ``--gail_ref``
(``results/torch/jax_head/gail``: the JAX package's, ``GAIL_seed_<s>``),
each seed's ``gail_eval_avg``, both sides' means, the seeds past the gate
(-190.0), and the two-sided Mann-Whitney p over the seeds both keep; the
rule closes C20 where p >= 0.05 over at least 8 seeds a side.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
from scipy.stats import fisher_exact, mannwhitneyu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOW = 50
EARLY = slice(10, 41)       # episodes 10-40
BREAKOUT = 100.0            # a stacked final-50 at or above it broke out


P_MIN = 0.05               # a p at or above it shows no difference
GREEDY_SLACK = 0.08         # FrozenLake's best-seed gate's slack


def side(root: str, env: str, stem: str, below: float | None = None) -> dict:
    """One side's per-seed statistics; with ``below``, the count of seeds
    whose stacked final-50 is below it."""
    with open(os.path.join(root, env, "provenance.json")) as f:
        prov = json.load(f)
    rec = prov["stacks"][stem]
    raw = [np.load(os.path.join(root, env, "seeds", name))
           for name in rec["files"]]
    stack = np.load(os.path.join(root, env, stem + ".npy"))
    final = stack[:, -WINDOW:].mean(1)
    extra = {} if below is None else dict(below=int((final < below).sum()))
    return dict(**extra,
        seeds=rec["seeds"],
        final50=[float(x) for x in final],
        final50_raw=[float(c[-WINDOW:].mean()) for c in raw],
        mean_final50=float(final.mean()),
        breakouts=int((final >= BREAKOUT).sum()),
        breakout_share=float((final >= BREAKOUT).mean()),
        env_steps=[prov["seeds"][name]["env_steps"] for name in rec["files"]],
        early_mean=[float(c[EARLY].mean()) for c in raw])


def mwu(a, b) -> dict:
    res = mannwhitneyu(a, b, alternative="two-sided")
    return dict(U=float(res.statistic), p=float(res.pvalue))


def fisher(a: dict, b: dict, key: str = "breakouts") -> dict:
    """Fisher's exact two-sided test of two sides' counts of ``key``
    (break-outs by default)."""
    table = [[a[key], len(a["seeds"]) - a[key]],
             [b[key], len(b["seeds"]) - b[key]]]
    res = fisher_exact(table, alternative="two-sided")
    return dict(table=table, odds_ratio=float(res.statistic),
                p=float(res.pvalue))


def greedy_rule(port: list, jax: list, slack: float = GREEDY_SLACK) -> dict:
    """C12's rule over per-seed greedy success rates: the two-sided
    Mann-Whitney p of the two sides' rates, each side's best, and whether
    the p is at least ``P_MIN`` and the port's best at least JAX's best
    less ``slack``."""
    test = mwu(port, jax)
    best_port, best_jax = float(max(port)), float(max(jax))
    return dict(mannwhitney=test, best_port=best_port, best_jax=best_jax,
                mean_port=float(np.mean(port)), mean_jax=float(np.mean(jax)),
                slack=slack, p_ok=test["p"] >= P_MIN,
                best_ok=best_port >= best_jax - slack,
                closes=test["p"] >= P_MIN and best_port >= best_jax - slack)


GAIL_GATE = -190.0          # SCALAR_GATES' GAIL_Pendulum_eval floor
GAIL_MIN_SEEDS = 8


def gail_evals(root: str) -> dict:
    """Seed -> ``gail_eval_avg`` of every GAIL run kept under
    ``<root>/Pendulum-v1/``: a ``GAIL_seed_<s>`` dir, or a run dir whose
    ``config.json`` names its seed. Two runs of one seed raise."""
    out = {}
    for d, _, files in sorted(os.walk(os.path.join(root, "Pendulum-v1"))):
        if "summary.json" not in files:
            continue
        name = os.path.basename(d)
        if name.startswith("GAIL_seed_"):
            seed = int(name.rsplit("_", 1)[1])
        else:
            with open(os.path.join(d, "config.json")) as f:
                seed = int(json.load(f)["seed"])
        if seed in out:
            raise ValueError(f"two GAIL runs of seed {seed} under {root}")
        with open(os.path.join(d, "summary.json")) as f:
            out[seed] = float(json.load(f)["gail_eval_avg"])
    return out


def gail_rule(ours_root: str, ref_root: str) -> dict:
    """C20's rule: over the seeds both sides keep, each side's per-seed
    ``gail_eval_avg``, mean and seeds past the gate, the two-sided
    Mann-Whitney p, and whether it closes C20 (p >= ``P_MIN`` over at
    least ``GAIL_MIN_SEEDS`` seeds)."""
    ours, ref = gail_evals(ours_root), gail_evals(ref_root)
    seeds = sorted(set(ours) & set(ref))
    a, b = [ours[s] for s in seeds], [ref[s] for s in seeds]
    test = mwu(a, b) if seeds else None
    return dict(seeds=seeds, port=a, jax=b,
                mean_port=float(np.mean(a)) if a else None,
                mean_jax=float(np.mean(b)) if b else None,
                gate=GAIL_GATE,
                past_gate_port=[s for s in seeds if ours[s] >= GAIL_GATE],
                past_gate_jax=[s for s in seeds if ref[s] >= GAIL_GATE],
                mannwhitney=test,
                closes=bool(test is not None and len(seeds) >= GAIL_MIN_SEEDS
                            and test["p"] >= P_MIN))


def committed(ours_root: str, committed_root: str, env: str,
              stem: str) -> dict:
    """The port's raw stack of ``stem`` against the JAX package's committed
    one, row by row: the final-``WINDOW`` means, their means and the
    two-sided Mann-Whitney p."""
    a, b = (np.load(os.path.join(root, env, f"{stem}.npy"))
            for root in (ours_root, committed_root))
    fa, fb = (np.asarray(x, np.float64)[:, -WINDOW:].mean(1).tolist()
              for x in (a, b))
    return dict(env=env, stem=stem, window=WINDOW, port=fa, jax=fb,
                mean_port=float(np.mean(fa)), mean_jax=float(np.mean(fb)),
                mannwhitney=mwu(fa, fb))


def spread(ours_root: str, ref_root: str, env: str, stem: str,
           below: float | None = None) -> dict:
    ours = side(ours_root, env, stem, below)
    ref = side(ref_root, env, stem, below)
    extra = {} if below is None else dict(
        below=below, fisher_below=fisher(ours, ref, "below"))
    return dict(
        env=env, stem=stem, breakout=BREAKOUT, port=ours, jax_head=ref,
        **extra, fisher_breakouts=fisher(ours, ref),
        mannwhitney=dict(
            final50=mwu(ours["final50"], ref["final50"]),
            final50_raw=mwu(ours["final50_raw"], ref["final50_raw"]),
            early=mwu(ours["early_mean"], ref["early_mean"])))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="LunarLander-v2")
    ap.add_argument("--stem", default="DQN_16_seed")
    ap.add_argument("--ours", default=os.path.join(
        ROOT, "results", "torch", "learning_curves"))
    ap.add_argument("--ref", default=os.path.join(
        ROOT, "results", "torch", "jax_head"))
    ap.add_argument("--below", type=float, default=None,
                    help="count the seeds whose final-50 is below this")
    ap.add_argument("--greedy", default=None,
                    help="a greedy-rate JSON of scripts/torch_c12_greedy.py")
    ap.add_argument("--gail", action="store_true",
                    help="C20's rule over the two sides' GAIL runs")
    ap.add_argument("--gail_ours", default=os.path.join(
        ROOT, "results", "torch", "gail"))
    ap.add_argument("--gail_ref", default=os.path.join(
        ROOT, "results", "torch", "jax_head", "gail"))
    ap.add_argument("--committed", action="store_true",
                    help="the port's stack against the JAX package's "
                         "committed one, draw by draw")
    args = ap.parse_args(argv)
    if args.committed:
        print(json.dumps(committed(
            args.ours, os.path.join(ROOT, "results", "learning_curves"),
            args.env, args.stem)), flush=True)
        return 0
    if args.gail:
        print(json.dumps(gail_rule(args.gail_ours, args.gail_ref)),
              flush=True)
        return 0
    if args.greedy:
        with open(args.greedy) as f:
            rates = json.load(f)
        print(json.dumps(dict(row=rates["row"], seeds=rates["seeds"],
                              port=rates["port"], jax=rates["jax"],
                              rule=greedy_rule(rates["port"],
                                               rates["jax"]))), flush=True)
        return 0
    print(json.dumps(spread(args.ours, args.ref, args.env, args.stem,
                            args.below)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
