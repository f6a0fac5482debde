"""The seed spread of one recipe in the port and in the JAX package, from
the two trees' curves (numpy and scipy only).

    python3 scripts/torch_seed_spread.py [--env LunarLander-v2]
        [--stem DQN_16_seed] [--ours results/torch/learning_curves]
        [--ref results/torch/jax_head]

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
the two sides' break-out counts.
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


def side(root: str, env: str, stem: str) -> dict:
    """One side's per-seed statistics."""
    with open(os.path.join(root, env, "provenance.json")) as f:
        prov = json.load(f)
    rec = prov["stacks"][stem]
    raw = [np.load(os.path.join(root, env, "seeds", name))
           for name in rec["files"]]
    stack = np.load(os.path.join(root, env, stem + ".npy"))
    final = stack[:, -WINDOW:].mean(1)
    return dict(
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


def fisher(a: dict, b: dict) -> dict:
    """Fisher's exact two-sided test of two sides' break-out counts."""
    table = [[a["breakouts"], len(a["seeds"]) - a["breakouts"]],
             [b["breakouts"], len(b["seeds"]) - b["breakouts"]]]
    res = fisher_exact(table, alternative="two-sided")
    return dict(table=table, odds_ratio=float(res.statistic),
                p=float(res.pvalue))


def spread(ours_root: str, ref_root: str, env: str, stem: str) -> dict:
    ours = side(ours_root, env, stem)
    ref = side(ref_root, env, stem)
    return dict(
        env=env, stem=stem, breakout=BREAKOUT, port=ours, jax_head=ref,
        fisher_breakouts=fisher(ours, ref),
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
    args = ap.parse_args(argv)
    print(json.dumps(spread(args.ours, args.ref, args.env, args.stem)),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
