"""The seed spread of one recipe in the port and in the JAX package, from
the two trees' curves (numpy and scipy only).

    python3 scripts/torch_seed_spread.py [--env LunarLander-v2]
        [--stem DQN_16_seed] [--ours results/torch/learning_curves]
        [--ref results/torch/jax_head] [--below X]
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
    args = ap.parse_args(argv)
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
