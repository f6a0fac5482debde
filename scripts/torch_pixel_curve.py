"""Pixel-CartPole DQN learning curves in the port (counterpart:
``scripts/pixel_curve.py``): the procedural 48x48 2-frame renderer
(``envs/pixel.py``) and the small conv trunk (``nets/cnn.py``) trained by
``train_offpolicy`` on the card.

    python3 scripts/torch_pixel_curve.py --seed S [--episodes 400]
        [--device cuda|cpu] [--root results/torch/learning_curves]
    python3 scripts/torch_pixel_curve.py [ARGS ...]

With ``--seed``, one run of the JAX script's configs (``golden.PIXEL_RUNS``,
verbatim: a replay of 100,000, batch 64, the 'small' trunk of 128
features, 8 envs, 1,000 start steps, 4 updates a vector step, chunks of
128), seeded with S, for ``--episodes`` episodes, as the JAX script calls
``train_offpolicy`` itself: neither CLI builds a conv trunk. The raw curve
is kept as ``golden.seed_file(ROOT, row, S)``
(``results/torch/learning_curves/PixelCartPole-v1/seeds/DQN_seed_<S>.npy``
by default; never the JAX package's ``results/learning_curves/``), and the
env's ``provenance.json`` records the command, the commit (where git is
there), the device and card, the seconds, the env steps, the updates, the
episodes and the sum-tree kernel's (B1's) launches, 0 on this path of
uniform replay. It runs on the card unless ``--device cpu`` asks; without
a card it exits non-zero.

Without ``--seed``, the two rows of ``golden.pixel_rows``
(``PixelCartPole-v1/DQN_seed_0`` and ``DQN_16_seed@jax_head``) run through
``scripts/torch_golden_card.py``, which takes every other argument
(``--device``, ``--per_card``, ``--force``, ``--deadline``, ``--seeds``,
``--log_dir``) and runs one such seed a job.
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
import torch  # noqa: E402

from freerl_tpu_torch import set_matmul_precision  # noqa: E402
from freerl_tpu_torch.train import golden  # noqa: E402

TAG = "DQN_pixel"


def configs(seed: int, obs_shape, tag: str = TAG, **loop):
    """The JAX script's ``DQNConfig`` and ``OffPolicyConfig`` for ``seed``
    (``golden.PIXEL_RUNS``), the loop's fields changed by ``loop``."""
    from freerl_tpu_torch.algos import DQNConfig
    from freerl_tpu_torch.train import OffPolicyConfig

    _, dqn, off = golden.PIXEL_RUNS[tag]
    return (DQNConfig(obs_shape=tuple(obs_shape), **dqn),
            OffPolicyConfig(seed=seed, **{**off, **loop}))


def train(seed: int, device: str = "cuda", tag: str = TAG, **loop) -> dict:
    """One run of ``configs`` on ``device``, with the sum-tree kernel's
    count set to 0 just before and read just after: the final state,
    the returns, the loop's info, the launches and the seconds."""
    from freerl_tpu_torch.algos import DQN
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.ops import sumtree
    from freerl_tpu_torch.train import train_offpolicy

    env = make(golden.PIXEL_RUNS[tag][0], device=device)
    dqn_cfg, loop_cfg = configs(seed, env.obs_shape, tag, **loop)
    algo = DQN(env.dim_info, dqn_cfg, device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    sumtree.launches = 0
    t0 = time.time()
    state, returns, info = train_offpolicy(env, algo, loop_cfg)
    sync()
    return dict(state=state, returns=np.asarray(returns), info=info,
                launches=sumtree.launches, seconds=time.time() - t0)


def _commit() -> str | None:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                              capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def run_seed(seed: int, episodes: int, device: str, root: str) -> dict:
    """Train ``seed`` and keep its curve and record under ``root``;
    returns the record."""
    row = golden.pixel_rows()[0]
    t0 = time.time()
    r = train(seed, device, max_episodes=episodes)
    info = r["info"]
    argv = ["--seed", str(seed)] + (
        [] if episodes == golden.PIXEL_RUNS[TAG][2]["max_episodes"]
        else ["--episodes", str(episodes)])
    card = None
    if device == "cuda":
        from chip_smoke import card_line
        card = card_line()
    rec = dict(
        command=shlex.join(["python", "-m", "scripts.torch_pixel_curve",
                            *argv, "--device", device]),
        commit=_commit(), device=device, card=card,
        seconds=round(time.time() - t0, 1),
        loop_s=round(float(info["elapsed_s"]), 1),
        env_steps=int(info["env_steps"]), updates=int(info["updates"]),
        episodes=int(info["episodes"]), b1_launches=int(r["launches"]),
        final50=round(float(r["returns"][-50:].mean()), 4))
    path = golden.seed_file(root, row, seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, r["returns"])
    golden.update_provenance(root, row.env,
                             seeds={os.path.basename(path): rec})
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        epilog="without --seed, other arguments go to "
               "scripts/torch_golden_card.py")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--episodes", type=int,
                    default=golden.PIXEL_RUNS[TAG][2]["max_episodes"])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--root", default=golden.OURS_ROOT,
                    help="the tree the seed's curve is kept under")
    args, rest = ap.parse_known_args(argv)
    if args.seed is None:
        from scripts import torch_golden_card as card

        keys = [golden.row_key(r) for r in golden.pixel_rows()]
        return card.main(keys + rest + ["--device", args.device])
    if rest:
        ap.error(f"unrecognized arguments: {rest}")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_pixel_curve: no CUDA card; pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        return 1
    # full float32 convolutions and matmuls, as the JAX package computes
    # them on the CPU (torch's default takes TF32 convolutions)
    set_matmul_precision("float32")
    rec = run_seed(args.seed, args.episodes, args.device, args.root)
    print(json.dumps(dict(seed=args.seed, **rec)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
