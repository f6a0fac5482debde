"""C12's greedy success rates: the final net of every seed of the r5
``DQN_FrozenLake`` recipe over 16 seeds (the rows
``FrozenLake-v1/DQN_16_seed@jax_head``), the port's and the JAX package's,
each scored greedily over many episodes by one evaluator.

    python3 scripts/torch_c12_greedy.py --port_logs DIR
        [--jax_logs build/jax_head] [--out results/torch/c12_greedy.json]

``--port_logs`` holds the logs ``scripts/torch_golden_card.py`` wrote for
the row's seeds (``<env>_<stem>_seed_<s>.log``, run with ``--results_root``
under the same tree, so each run dir, with its ``checkpoint`` and
``config.json``, came back with it); ``--jax_logs`` the logs
``scripts/torch_jax_head.py`` wrote (``<env>_<stem>_<s>.log``). Each log
names its run dir (``golden.parse_run_log``), which must be where the
log says: copy a run's output tree back to the path it was written at.

Every net is scored on the CPU by the port's evaluator
(``freerl_tpu_torch/train/evaluate.py:evaluate``, greedy
``evaluate_action``) over ``N_EPISODES`` episodes from one ``SEED0``, so all
nets meet the same episode draws: the port's nets loaded as
``freerl_tpu_torch/eval.py`` loads a run, the JAX nets brought across with
``convert.dqn_params_from_flax``. The JAX nets are also scored by the JAX
package's own evaluator (``freerl_tpu/train/evaluate.py:evaluate``, the load
of ``freerl_tpu/eval.py``), in a JAX process of its own on the CPU; the two
evaluators of a JAX net must agree within ``AGREE`` (3 standard errors of
the difference of two independent 1,000-episode rates at any rate).

The JSON written to ``--out`` holds the commands, every seed's rates and
run dir, the evaluators' largest gap, and C12's rule
(``scripts/torch_seed_spread.py:greedy_rule``). The script imports nothing
of JAX and nothing of the JAX package; it exits non-zero if the evaluators
disagree.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from freerl_tpu_torch.train import golden  # noqa: E402
from scripts.torch_seed_spread import greedy_rule  # noqa: E402

ROW = "FrozenLake-v1/DQN_16_seed@jax_head"
# C12's rule was fixed for rates over these episodes, drawn from this seed
N_EPISODES = 1000
SEED0 = 0
# the largest gap allowed between the two evaluators' rates of one net:
# 3 * sqrt(2 * 0.5 * 0.5 / 1000), the standard error at p = 0.5
AGREE = 0.07

# run in a process of its own: each JAX run dir loaded as the JAX package's
# eval.py loads it, scored by the JAX package's evaluator, and its Q-net's
# params kept as numpy
_JAX_CODE = """
import json, os, pickle, sys
from types import SimpleNamespace
import jax
import numpy as np
from freerl_tpu import eval as jeval
from freerl_tpu.cli import build
from freerl_tpu.train.evaluate import evaluate
from freerl_tpu.train.runio import load_checkpoint

req = json.loads(sys.argv[1])
out = {}
for run_dir in req["run_dirs"]:
    args = jeval._build_args(SimpleNamespace(model_dir=run_dir))
    env, algo = build(args)
    state = load_checkpoint(os.path.join(run_dir, "checkpoint"),
                            algo.init(jax.random.PRNGKey(0)))
    ret = evaluate(env, lambda o: algo.evaluate_action(state, o),
                   n_episodes=req["n_episodes"], seed0=req["seed0"])
    out[run_dir] = dict(rate=float(np.mean(ret)),
                        params=jax.tree.map(np.asarray, state.params))
with open(req["out"], "wb") as f:
    pickle.dump(out, f)
"""


def run_dir_of(log: str) -> str:
    """The run dir a CLI log names; it must be there."""
    with open(log) as f:
        run_dir = golden.parse_run_log(f.read())["run_dir"]
    if not os.path.isdir(run_dir):
        raise FileNotFoundError(f"{log}: run dir {run_dir} not found")
    return run_dir


def port_policy(run_dir: str, params: dict | None = None):
    """(env, greedy act_fn) on the CPU of the port's algo built from
    ``run_dir``'s ``config.json``: its net loaded from the run's checkpoint,
    or, given ``params`` (a flax Q-net tree of numpy arrays), from those."""
    from freerl_tpu_torch import eval as teval
    from freerl_tpu_torch.cli import build
    from freerl_tpu_torch.convert import dqn_params_from_flax

    args = teval.parse(["--model_dir", run_dir, "--device", "cpu"])
    if params is None:
        env, _, act_fn, _ = teval.load_policy(args)
        return env, act_fn
    env, algo = build(args)
    state = algo.init(torch.Generator().manual_seed(0))
    state.net.load_state_dict(dqn_params_from_flax(
        params, dueling="Dueling" in args.trick))
    return env, lambda obs: algo.evaluate_action(state, obs)


def greedy_rate(run_dir: str, n_episodes: int, seed0: int,
                params: dict | None = None) -> float:
    """The success rate of the net's greedy policy over ``n_episodes``
    episodes of the port's evaluator (FrozenLake pays 1 at the goal)."""
    from freerl_tpu_torch.train.evaluate import evaluate

    env, act_fn = port_policy(run_dir, params)
    return float(np.mean(evaluate(env, act_fn, n_episodes=n_episodes,
                                  seed0=seed0)))


def jax_nets(run_dirs: list, n_episodes: int, seed0: int) -> dict:
    """run dir -> the JAX evaluator's rate and the Q-net's params, from one
    JAX process on the CPU."""
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "nets.pkl")
        subprocess.run(
            [sys.executable, "-c", _JAX_CODE, json.dumps(dict(
                run_dirs=run_dirs, n_episodes=n_episodes, seed0=seed0,
                out=out))],
            cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"), check=True)
        with open(out, "rb") as f:
            return pickle.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port_logs", required=True)
    ap.add_argument("--jax_logs", default=os.path.join(ROOT, "build",
                                                       "jax_head"))
    ap.add_argument("--out", default=os.path.join(
        ROOT, "results", "torch", "c12_greedy.json"))
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    row = next(r for r in golden.JAX_PARITY if golden.row_key(r) == ROW)
    seeds = list(row.regen_seeds)
    port_dirs = [run_dir_of(os.path.join(
        args.port_logs, f"{row.env}_{row.algo}_seed_{s}.log")) for s in seeds]
    jax_dirs = [run_dir_of(os.path.join(
        args.jax_logs, f"{row.env}_{row.algo}_{s}.log")) for s in seeds]
    nets = jax_nets(jax_dirs, N_EPISODES, SEED0)
    port = [greedy_rate(d, N_EPISODES, SEED0) for d in port_dirs]
    jax = [greedy_rate(d, N_EPISODES, SEED0, nets[d]["params"])
           for d in jax_dirs]
    jax_own = [nets[d]["rate"] for d in jax_dirs]
    gap = float(np.max(np.abs(np.subtract(jax, jax_own))))
    rel = lambda p: os.path.relpath(p, ROOT)   # noqa: E731
    out = dict(
        row=ROW, seeds=seeds, n_episodes=N_EPISODES, seed0=SEED0,
        command=" ".join(["python3", "scripts/torch_c12_greedy.py",
                          *(argv if argv is not None else sys.argv[1:])]),
        evaluator="freerl_tpu_torch/train/evaluate.py:evaluate, greedy, "
                  "on the CPU",
        port=port, jax=jax, jax_own_evaluator=jax_own,
        evaluator_gap_max=gap, agree=AGREE, evaluators_agree=gap <= AGREE,
        port_run_dirs=[rel(d) for d in port_dirs],
        jax_run_dirs=[rel(d) for d in jax_dirs],
        rule=greedy_rule(port, jax))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0 if gap <= AGREE else 1


if __name__ == "__main__":
    raise SystemExit(main())
