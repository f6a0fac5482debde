"""The port's run dirs, metric files and full-state checkpoints
(``train/runio.py``).

``trick_prefix`` / ``make_dir`` and the curve file are held against the
JAX package's on one table. Checkpoints are port-only and exact: the state
of every algo the CLI builds, moved off its init (every tensor, every
optimizer's moments and host counters), must come back bit for bit into a
fresh init, in place; and after a load, one more update from identical
inputs and draws must give the live run's state bit for bit
(``chip_smoke.checkpoint_roundtrip``, the card phase's own check, here on
the CPU).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
from torch import nn

from chip_smoke import (CHECKPOINT_CASES, checkpoint_roundtrip, cli_args,
                        tree_diffs)
from freerl_tpu.train import runio as jax_runio
from freerl_tpu_torch.cli import MARL_OFF, MARL_ON, OFFPOLICY, ONPOLICY, build
from freerl_tpu_torch.train.runio import (MetricsWriter, load_checkpoint,
                                          make_dir, save_checkpoint,
                                          state_tree, trick_prefix)

torch.set_num_threads(1)

TRICKS = [None, {}, {"Double": True}, {"Double": True, "PER": True,
                                       "Noisy": False},
          {"Noisy": False}, {"ObsNorm": True, "tanh": True, "Beta": True}]


@pytest.mark.parametrize("trick", TRICKS)
def test_trick_prefix_equals_jax(trick):
    for policy in ("DQN", "PPO", "MAPPO"):
        assert trick_prefix(policy, trick) == jax_runio.trick_prefix(
            policy, trick)


def test_make_dir_numbering_equals_jax(tmp_path):
    roots = [tmp_path / "port", tmp_path / "jax"]
    for root in roots:        # runs already there, and names that differ
        for name in ("DQN_3", "DQN_Double_1", "DQN_x", "PPO_2"):
            os.makedirs(root / "CartPole-v1" / name)
    for policy, trick in [("DQN", None), ("DQN", {"Double": True}),
                          ("DQN", {"Double": True}), ("PPO", {}),
                          ("DQN", {"PER": True})]:
        got = make_dir(str(roots[0]), "CartPole-v1", policy, trick)
        want = jax_runio.make_dir(str(roots[1]), "CartPole-v1", policy,
                                  trick)
        assert os.path.basename(got) == os.path.basename(want)
    assert sorted(os.listdir(roots[0] / "CartPole-v1")) == sorted(
        os.listdir(roots[1] / "CartPole-v1"))
    assert os.path.isdir(roots[0] / "CartPole-v1" / "DQN_Double_3")


def test_make_dir_takes_the_next_number_a_concurrent_run_left(tmp_path,
                                                              monkeypatch):
    """Two runs started together read the same listing: the one that
    creates its dir second takes the next free number instead of
    failing (a stale listing stands for the other run)."""
    from freerl_tpu_torch.train import runio

    os.makedirs(tmp_path / "CartPole-v1" / "DQN_1")
    os.makedirs(tmp_path / "CartPole-v1" / "DQN_2")
    monkeypatch.setattr(runio.os, "listdir", lambda d: [])
    got = make_dir(str(tmp_path), "CartPole-v1", "DQN")
    assert os.path.basename(got) == "DQN_3" and os.path.isdir(got)


@pytest.mark.parametrize("tensorboard", [False, True])
def test_metrics_writer_curve(tmp_path, tensorboard):
    returns = np.random.RandomState(0).randn(7, 3).astype(np.float32)
    dirs = []
    for which, cls in (("port", MetricsWriter),
                       ("jax", jax_runio.MetricsWriter)):
        d = tmp_path / which
        os.makedirs(d)
        w = cls(str(d), "MAPPO", seed=5, use_tensorboard=tensorboard)
        w.log_episodes(returns)
        w.log_scalar("loss", 0.5, 1)
        path = w.save_curve(returns)
        w.close()
        assert os.path.basename(path) == "MAPPO_seed_5.npy"
        dirs.append(d)
    port, jax = (np.load(d / "MAPPO_seed_5.npy") for d in dirs)
    np.testing.assert_array_equal(port, jax)
    assert port.dtype == jax.dtype
    events = [f for f in os.listdir(dirs[0]) if f.startswith("events")]
    assert bool(events) == tensorboard


# every algo the CLI builds, with the trick tables' constructions
BUILDS = {
    "DQN": dict(env_name="CartPole-v1"),
    "DQN_rainbow": dict(algo="DQN", env_name="CartPole-v1",
                        trick=["Double", "Dueling", "PER", "Noisy",
                               "N_Step", "Categorical"]),
    "DDPG": dict(env_name="Pendulum-v1"),
    "DDPG_supplements": dict(algo="DDPG", env_name="Pendulum-v1",
                             trick=["weight_decay", "OUNoise", "ObsNorm",
                                    "net_init", "PopArt"]),
    "TD3": dict(env_name="Pendulum-v1"),
    "SAC": dict(env_name="Pendulum-v1"),
    "ENVELOPE": dict(env_name="deep-sea-treasure-v0"),
    "PPO": dict(env_name="CartPole-v1"),
    "PPO_tricks": dict(algo="PPO", env_name="Pendulum-v1",
                       trick=["adv_norm", "ObsNorm", "reward_scaling",
                              "lr_decay", "orthogonal_init", "adam_eps",
                              "tanh", "Beta"]),
    "REINFORCE": dict(env_name="CartPole-v1"),
    "MAT": dict(env_name="simple_spread_v3"),
    "MADDPG": dict(env_name="simple_spread_v3", trick=["ATT"]),
    "MATD3": dict(env_name="simple_spread_v3"),
    "MASAC": dict(env_name="simple_spread_v3"),
    "MAAC": dict(env_name="simple_spread_v3"),
    "MAPPO": dict(env_name="simple_spread_v3"),
    "MAPPO_attention": dict(algo="MAPPO", env_name="simple_spread_v3",
                            trick=["attention", "ObsNorm", "LayerNorm"]),
    "HAPPO": dict(env_name="simple_spread_v3"),
    "IPPO": dict(env_name="simple_adversary_v3"),
    "RMAPPO": dict(env_name="simple_spread_v3"),
    "RIPPO": dict(env_name="simple_spread_v3", discrete_actions=True),
}


def test_builds_cover_every_cli_algo():
    assert {v.get("algo", k) for k, v in BUILDS.items()} == (
        OFFPOLICY | ONPOLICY | MARL_OFF | MARL_ON)


def perturb(x, g: torch.Generator):
    """Move every tensor, optimizer and host number of a state off its
    init, in place where the state holds objects."""
    if isinstance(x, nn.Module):
        with torch.no_grad():
            for t in (*x.parameters(), *x.buffers()):
                if t.is_floating_point():
                    t.add_(torch.randn(t.shape, generator=g))
    elif isinstance(x, torch.optim.Optimizer):
        params = [p for group in x.param_groups for p in group["params"]]
        for p in params:
            p.grad = torch.randn(p.shape, generator=g)
        x.step()
        for p in params:
            p.grad = None
        for group in x.param_groups:
            group["lr"] *= 0.37
    elif isinstance(x, torch.Tensor):
        with torch.no_grad():
            if x.is_floating_point():
                x.add_(torch.randn(x.shape, generator=g))
            elif x.dtype != torch.bool:
                x.add_(3)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            v = getattr(x, f.name)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                setattr(x, f.name, v + 3)
            else:
                perturb(v, g)
    elif isinstance(x, (list, tuple)):
        for v in x:
            perturb(v, g)


def optimizer_params(state) -> list:
    """The ids of every optimizer's params, in order."""
    out = []
    if isinstance(state, torch.optim.Optimizer):
        return [id(p) for group in state.param_groups
                for p in group["params"]]
    if dataclasses.is_dataclass(state):
        for f in dataclasses.fields(state):
            out += optimizer_params(getattr(state, f.name))
    elif isinstance(state, (list, tuple)):
        for v in state:
            out += optimizer_params(v)
    return out


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_checkpoint_roundtrip_every_cli_algo(case, tmp_path):
    flags = dict(BUILDS[case])
    flags.setdefault("algo", case)
    _, algo = build(cli_args(**flags, device="cpu", num_envs=4,
                             horizon=64))
    state = algo.init(torch.Generator().manual_seed(0))
    perturb(state, torch.Generator().manual_seed(1))
    path = save_checkpoint(str(tmp_path / "run" / "checkpoint"), state)
    assert os.path.isfile(path) and not os.path.exists(path + ".tmp")
    fresh = algo.init(torch.Generator().manual_seed(2))
    params = optimizer_params(fresh)
    want = state_tree(state)
    assert tree_diffs(want, state_tree(fresh))
    restored = load_checkpoint(path, fresh)
    assert restored is fresh
    assert tree_diffs(want, state_tree(restored)) == []
    # the optimizers still step the module's own parameters
    assert optimizer_params(restored) == params


@pytest.mark.parametrize("name", list(CHECKPOINT_CASES))
def test_bit_exact_continuation_after_load(name, tmp_path):
    r = checkpoint_roundtrip(name, "cpu", str(tmp_path / "ckpt"))
    assert r["bytes"] > 0 and r["updates"] == CHECKPOINT_CASES[name][1] + 1


@dataclasses.dataclass
class _Odd:
    weights: torch.Tensor
    extra: object


@pytest.mark.parametrize("extra,kind", [
    (np.zeros(3), "ndarray"),
    (np.random.RandomState(0), "RandomState"),
    (np.float32(1.0), "float32"),
    ([1, {"a": np.ones(2)}], "ndarray"),
])
def test_unsupported_field_raises(extra, kind, tmp_path):
    state = _Odd(weights=torch.ones(2), extra=extra)
    with pytest.raises(TypeError, match=rf"state\.extra.* is a {kind}"):
        save_checkpoint(str(tmp_path / "ckpt"), state)
    assert not os.path.exists(tmp_path / "ckpt")


def test_load_refuses_a_mismatched_example(tmp_path):
    path = save_checkpoint(str(tmp_path / "ckpt"),
                           _Odd(weights=torch.ones(2), extra=[1, 2]))
    with pytest.raises(ValueError, match="state.weights has shape"):
        load_checkpoint(path, _Odd(weights=torch.ones(3), extra=[1, 2]))
    with pytest.raises(ValueError, match=r"state.extra has 2 items"):
        load_checkpoint(path, _Odd(weights=torch.ones(2), extra=[1]))
    restored = load_checkpoint(path, _Odd(weights=torch.zeros(2),
                                          extra=[5, 6]))
    assert restored.extra == [1, 2] and torch.equal(restored.weights,
                                                    torch.ones(2))
