"""ENVELOPE on deep-sea-treasure, end to end, in the port (counterpart:
``scripts/envelope_e2e.py`` with ``scripts/envelope_seed_sweep.sh``'s
recipe): training through the port's CLI on the card, then the
100-preference Pareto sweep of each run.

    python3 scripts/torch_envelope_e2e.py [ARGS ...]
    python3 scripts/torch_envelope_e2e.py --model_dir DIR [--device cuda|cpu]
    python3 scripts/torch_envelope_e2e.py --probe EPISODES [--per_card K]
        [--device cuda|cpu] [--deadline S] [--log_dir DIR] [--runs_root DIR]

With no ``--model_dir`` or ``--probe``, the script runs the two rows of
``golden.envelope_rows`` (``deep-sea-treasure-v0/ENVELOPE_16_seed@jax_head``
and ``ENVELOPE_sweep_16_seed@jax_head``: ``golden.envelope_argv``, the
shell recipe's 1-env protocol, over ``golden.DQN_LL_SEEDS16``) through
``scripts/torch_golden_card.py``, which takes every other argument
(``--device``, ``--per_card``, ``--force``, ``--deadline``, ``--seeds``,
``--results_root``, ``--log_dir``). Each seed trains once for both rows and
its final checkpoint is swept right after training, in the same process
(``--and_sweep``); the seed's raw 5,000-episode curve and its 100 sweep
returns are kept under ``golden.OURS_ROOT``
(``results/torch/learning_curves/deep-sea-treasure-v0/seeds/``, never the
JAX package's ``results/learning_curves/``) and stacked raw beside them.
There is no 8-env training stage: no committed artifact or row comes from
``envelope_e2e.py --train``.

``--model_dir DIR`` sweeps one run dir (the JAX script's second stage):
the 100 preferences ``w = (w1, 1 - w1)``, ``w1 = 0, 0.01, ..., 0.99``, as
one batch of 100 envs rolled for ``env.max_steps`` steps from the reset,
each row's return masked once its episode is done, the action
``Envelope.evaluate_action`` under the row's preference, in full float32
matmuls as the CLI trains ENVELOPE; then precision, recall, CR and AE
against the true Pareto front, as ``envelope_e2e.py`` computes them. It
writes ``reward.npy`` (the 100 scalarized returns) and
``sweep_summary.json`` into DIR and prints the summary as one JSON line.

``--probe EPISODES`` trains seed 0 for EPISODES episodes
(``torch_golden_card.probe``; run dirs under ``--runs_root``, by default
``torch_golden_card.PROBE_RUNS_ROOT``) and keeps no curve; besides the
probe's record (``torch_golden_card.probe_record``) it projects each
seed's seconds on the card under the record's ``projections``: the probe's
loop seconds an env step times the env steps the JAX package's run of that
seed took (its provenance under ``golden.JAX_HEAD_ROOT``, else its run in
the recipe's committed TPU log, ``results/envelope_seed_sweep.log``), plus
the probe's start-up.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from freerl_tpu_torch.train import golden  # noqa: E402

# the true deep-sea-treasure Pareto front (eval_agent.py:12-14)
TIME = [-1, -3, -5, -7, -8, -9, -13, -14, -17, -19]
TREASURE = [0.7, 8.2, 11.5, 14.0, 15.1, 16.1, 19.6, 20.3, 22.4, 23.7]


def find_in(A, B, tol=0.3):
    """The share of the points of A that lie within ``tol`` (L1) of a point
    of B (eval_agent.py:110-131, base=2)."""
    cnt = 0.0
    for a in A:
        for b in B:
            if np.linalg.norm(a - b, ord=1) < tol:
                cnt += 1.0
                break
    return cnt / len(A)


def preferences() -> np.ndarray:
    """The sweep's 100 preferences, (100, 2) float32."""
    w1 = np.arange(0, 1, 0.01, dtype=np.float32)
    return np.stack([w1, 1.0 - w1], axis=1)


def rollout(algo, state, env, ws):
    """Each preference's episode from the reset, as one batch: the
    scalarized returns (100,) and the vector returns (100, 2), each
    counting the steps before its episode ended."""
    import torch

    dev = algo.device
    w = torch.as_tensor(ws, device=dev)
    s, obs = env.reset(env.draw_reset(len(ws), None))
    done = torch.zeros(len(ws), dtype=torch.bool, device=dev)
    ret = torch.zeros(len(ws), device=dev)
    vec = torch.zeros((len(ws), env.reward_dim), device=dev)
    for _ in range(env.max_steps):
        a = algo.evaluate_action(state, obs, w)
        s, obs, r, term, trunc = env.step(s, a, None)
        live = ~done
        ret = ret + torch.where(live, (w * r).sum(1), 0.0)
        vec = vec + torch.where(live[:, None], r, torch.zeros_like(r))
        done = done | term | trunc
    return ret.cpu().numpy(), vec.cpu().numpy()


def metrics(ws: np.ndarray, vecs: np.ndarray) -> dict:
    """Precision, recall, CR and AE of the sweep's vector returns against
    the true front (envelope_e2e.py:95-106)."""
    w_e = ws / np.linalg.norm(ws, ord=2, axis=1, keepdims=True)
    realc = (ws * vecs).sum(1, keepdims=True) * w_e
    front = np.stack([np.asarray(TREASURE), np.asarray(TIME)], axis=1)
    ids = np.argmax(ws @ front.T, axis=1)
    realc_dst = (ws * front[ids]).sum(1, keepdims=True) * w_e
    precision = find_in(realc, realc_dst)
    recall = find_in(realc_dst, realc)
    cr = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    base = np.linalg.norm(realc_dst, ord=2, axis=1)
    ae = float((np.linalg.norm(realc_dst - realc, ord=2, axis=1)
                / np.maximum(base, 1e-8)).sum())
    return {"precision": precision, "recall": recall, "CR": cr, "AE": ae}


def load_state(model_dir: str, device: str):
    """The env, the algo and the trained state of a run dir: the default
    ``EnvelopeConfig`` (the nets the CLI's config trains), the checkpoint
    loaded into its init."""
    import torch

    from freerl_tpu_torch.algos.envelope import Envelope, EnvelopeConfig
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.train.runio import load_checkpoint

    env = make("deep-sea-treasure-v0", device=device)
    algo = Envelope(env.dim_info, env.reward_dim, EnvelopeConfig(),
                    device=device)
    example = algo.init(torch.Generator(device=device).manual_seed(0))
    state = load_checkpoint(os.path.join(model_dir, "checkpoint"), example)
    return env, algo, state


def sweep(model_dir: str, device: str = "cuda") -> dict:
    """Sweep one run dir; writes ``reward.npy`` and ``sweep_summary.json``
    there and returns the summary."""
    if not os.environ.get("FREERL_MATMUL_PRECISION"):
        from freerl_tpu_torch import set_matmul_precision

        set_matmul_precision("float32")
    env, algo, state = load_state(model_dir, device)
    ws = preferences()
    rets, vecs = rollout(algo, state, env, ws)
    np.save(os.path.join(model_dir, "reward.npy"), rets)
    summary = {"sweep_mean_scalarized_return": float(rets.mean()),
               "reference_sweep_mean": 12.76, **metrics(ws, vecs)}
    with open(os.path.join(model_dir, "sweep_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary), flush=True)
    return summary


def train_and_sweep(argv: list) -> int:
    """One seed of the card runner: the port's CLI with ``argv``, then the
    sweep of its run dir on the CLI's device."""
    from freerl_tpu_torch import cli

    model_dir = cli.run(argv)
    sweep(model_dir, cli.parser().parse_args(argv).device)
    return 0


def row_keys() -> list:
    """The rows the recipe's runs feed (``golden.row_key``)."""
    return [golden.row_key(r) for r in golden.envelope_rows()]


# the JAX package's committed log of the recipe's seeds on the TPU
SEED_SWEEP_LOG = os.path.join(ROOT, "results", "envelope_seed_sweep.log")


def logged_env_steps(path: str = SEED_SWEEP_LOG) -> dict:
    """The env steps of each seed's run in scripts/envelope_seed_sweep.sh's
    log: ``{seed: steps}``, the larger where the log ran a seed twice."""
    import re

    out, seed = {}, None
    with open(path) as f:
        for line in f:
            m = re.search(r"\] seed (\d+): train", line)
            if m:
                seed = int(m.group(1))
            m = re.search(r"env_steps: (\d+)", line)
            if m and seed is not None:
                out[seed] = max(out.get(seed, 0), int(m.group(1)))
                seed = None
    return out


def projections(record: dict, head_root: str = golden.JAX_HEAD_ROOT) -> dict:
    """Each seed's projected seconds on the card: the probe's loop seconds
    an env step times the seed's env steps, plus the probe's start-up. The
    steps are those of the JAX package's run of the seed at this commit
    (its provenance under ``head_root``), else of its run in the recipe's
    committed TPU log (``logged_env_steps``), else the most that log
    holds."""
    row = golden.envelope_rows()[0]
    path = os.path.join(head_root, row.env, "provenance.json")
    seeds = {}
    if os.path.isfile(path):
        with open(path) as f:
            seeds = json.load(f).get("seeds", {})
    logged = logged_env_steps()
    per_step = record["loop_s"] / record["env_steps"]
    startup = record["seconds"] - record["loop_s"]
    out = {}
    for s in row.regen_seeds:
        rec = seeds.get(os.path.basename(golden.seed_file("", row, s)))
        steps, src = ((rec["env_steps"], "jax_head") if rec else
                      (logged[s], "log") if s in logged else
                      (max(logged.values()), "log_max"))
        out[str(s)] = dict(env_steps=steps, source=src,
                           projected_s=round(per_step * steps + startup, 1))
    return dict(s_per_env_step=per_step, startup_s=round(startup, 1),
                seeds=out,
                longest_s=max(v["projected_s"] for v in out.values()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        epilog="other arguments go to scripts/torch_golden_card.py")
    ap.add_argument("--probe", type=int, default=None, metavar="EPISODES",
                    help="time seed 0 for EPISODES episodes")
    ap.add_argument("--model_dir", default=None,
                    help="sweep this run dir only")
    ap.add_argument("--and_sweep", nargs=argparse.REMAINDER, default=None,
                    help=argparse.SUPPRESS)
    args, rest = ap.parse_known_args(argv)
    if args.and_sweep is not None:
        return train_and_sweep(args.and_sweep)
    if args.model_dir is not None:
        dp = argparse.ArgumentParser()
        dp.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
        sweep(args.model_dir, dp.parse_args(rest).device)
        return 0
    from scripts import torch_golden_card as card

    if args.probe is None:
        return card.main(row_keys() + rest)
    return card.probe(
        ["ENVELOPE"], args.probe, rest,
        lambda tag, seed, results_root=None: golden.envelope_argv(
            seed, results_root, tag),
        golden.ENVELOPE_RUNS, os.path.join(ROOT, "build", "envelope_probe"),
        project=projections)


if __name__ == "__main__":
    raise SystemExit(main())
