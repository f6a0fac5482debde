"""The port's training CLI and eval CLI (``cli.py``, ``eval.py``).

``build`` is held against the JAX package's: for every algo of the four
sets, with no tricks and with each trick table turned on, the config the
port builds equals the JAX one field for field (less the dead fields the
port leaves out), on the same env. Then the console contract and the run
dir end to end on the CPU (``--device cpu``): the artifact set, the
``config.json`` round trip into ``eval.py``, ENVELOPE's ``--preference``,
the recurrent GIF, the SMAC-protocol route and the mid-run checkpoint.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from chip_smoke import cli_args
from freerl_tpu import cli as jax_cli
from freerl_tpu_torch import eval as port_eval
from freerl_tpu_torch.cli import (_DDPG_SUPPLEMENTS, _DQN_TRICKS,
                                  _MAPPO_TRICKS, _PPO_TRICKS, _RMAPPO_TRICKS,
                                  MARL_OFF, MARL_ON, OFFPOLICY, ONPOLICY,
                                  build, main, run)
from freerl_tpu_torch.train.runio import load_checkpoint

torch.set_num_threads(1)

# the JAX configs' fields that nothing reads, which the port leaves out
DEAD = {"DDPGConfig": {"gumbel_temperature"}, "PPOConfig": {"critic_lr"},
        "REINFORCEConfig": {"num_envs"}}

MPE = "simple_spread_v3"
# (algo, env, tricks): every algo bare, then with its trick table on (the
# two reward normalizers, which exclude each other, one at a time)
ALL_PPO = [t for t in _PPO_TRICKS if t != "reward_norm"]
ALL_MAPPO = [t for t in _MAPPO_TRICKS if t != "reward_norm"]
CASES = [(a, "CartPole-v1", []) for a in ("DQN", "PPO", "REINFORCE")] + [
    (a, "Pendulum-v1", []) for a in ("DDPG", "TD3", "SAC")] + [
    ("ENVELOPE", "deep-sea-treasure-v0", []),
    ("MAT", MPE, []), ("MADDPG", MPE, []), ("MADDPG", MPE, ["ATT"]),
    ("MATD3", MPE, []), ("MASAC", MPE, []), ("MAAC", MPE, []),
    ("MAPPO", MPE, []), ("HAPPO", MPE, []),
    ("IPPO", "simple_adversary_v3", []), ("RMAPPO", MPE, []),
    ("RIPPO", MPE, []),
    ("DQN", "CartPole-v1", list(_DQN_TRICKS)),
    ("DDPG", "Pendulum-v1", [t for t in _DDPG_SUPPLEMENTS
                             if t != "gumbel"]),
    ("DDPG", "CartPole-v1", ["gumbel", "ObsNorm"]),
    ("PPO", "Pendulum-v1", ALL_PPO),
    ("PPO", "CartPole-v1", ["reward_norm", "adv_norm", "lr_decay"]),
    ("MAPPO", MPE, [t for t in ALL_MAPPO if t != "attention"]),
    ("MAPPO", MPE, ["attention", "reward_norm", "ValueClip"]),
    ("HAPPO", MPE, ALL_MAPPO[:6]),
    ("IPPO", "simple_adversary_v3", [t for t in ALL_MAPPO
                                     if t != "attention"]),
    ("RMAPPO", MPE, [t for t in _RMAPPO_TRICKS if t != "reward_norm"]),
    ("RIPPO", MPE, ["reward_norm", "LayerNorm"]),
]


@pytest.fixture
def jax_precision():
    """The JAX CLI's ENVELOPE branch sets a process-wide matmul precision;
    put it back for the tests that follow."""
    before = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", before)


def test_cases_cover_every_algo_and_trick():
    assert {a for a, _, _ in CASES} == OFFPOLICY | ONPOLICY | MARL_OFF | \
        MARL_ON
    used = {t for _, _, tricks in CASES for t in tricks}
    for table in (_DQN_TRICKS, _PPO_TRICKS, _MAPPO_TRICKS, _DDPG_SUPPLEMENTS,
                  _RMAPPO_TRICKS):
        assert set(table) <= used
    assert jax_cli._DQN_TRICKS == _DQN_TRICKS
    assert jax_cli._PPO_TRICKS == _PPO_TRICKS
    assert jax_cli._MAPPO_TRICKS == _MAPPO_TRICKS
    assert jax_cli._DDPG_SUPPLEMENTS == _DDPG_SUPPLEMENTS
    assert jax_cli._RMAPPO_TRICKS == _RMAPPO_TRICKS
    assert (jax_cli.OFFPOLICY, jax_cli.ONPOLICY, jax_cli.MARL_OFF,
            jax_cli.MARL_ON) == (OFFPOLICY, ONPOLICY, MARL_OFF, MARL_ON)


@pytest.mark.parametrize("algo,env_name,tricks", CASES,
                         ids=[f"{a}-{len(t)}" for a, _, t in CASES])
def test_build_config_equals_jax(algo, env_name, tricks, jax_precision):
    args = cli_args(algo=algo, env_name=env_name, trick=tricks, num_envs=4,
                    horizon=256, buffer_size=4096, device="cpu")
    env, port = build(args)
    jenv, jax_algo = jax_cli.build(args)
    assert type(port).__name__ == type(jax_algo).__name__
    assert env.name == jenv.name
    assert dataclasses.asdict(env.dim_info) == {
        f.name: getattr(jenv.dim_info, f.name)
        for f in dataclasses.fields(jenv.dim_info)}
    want = dataclasses.asdict(jax_algo.cfg)
    for field in DEAD.get(type(jax_algo.cfg).__name__, ()):
        del want[field]
    assert dataclasses.asdict(port.cfg) == want
    assert port.device == torch.device("cpu")


def test_build_rejects_unknown_trick_and_algo():
    with pytest.raises(SystemExit, match="unknown trick"):
        build(cli_args(trick=["NotATrick"], device="cpu"))
    with pytest.raises(SystemExit, match="unknown algo"):
        build(cli_args(algo="A2C", device="cpu"))
    with pytest.raises(SystemExit, match="use_state"):
        build(cli_args(algo="RMAPPO", env_name="fake-smac", use_state=True,
                       device="cpu"))


def cpu_run(tmp_path, *flags):
    return run([*flags, "--results_root", str(tmp_path), "--no_tensorboard",
                "--device", "cpu"])


def test_cli_main_exit_code(tmp_path):
    assert main(["--algo", "DQN", "--env_name", "CartPole-v1",
                 "--max_episodes", "5", "--num_envs", "4",
                 "--buffer_size", "1024", "--results_root", str(tmp_path),
                 "--no_tensorboard", "--device", "cpu"]) == 0


def test_cli_run_dir_and_eval_config_roundtrip(tmp_path):
    out_dir = cpu_run(tmp_path, "--algo", "DQN", "--env_name",
                      "CartPole-v1", "--max_episodes", "30", "--num_envs",
                      "4", "--buffer_size", "2048")
    run_dir = tmp_path / "CartPole-v1" / "DQN_1"
    assert out_dir == str(run_dir)
    assert {"config.json", "DQN_seed_0.npy", "checkpoint"} <= set(
        os.listdir(run_dir))
    curve = np.load(run_dir / "DQN_seed_0.npy")
    assert len(curve) == 30 and np.isfinite(curve).all()
    config = json.loads((run_dir / "config.json").read_text())
    assert config["device"] == "cpu" and config["buffer_size"] == 2048
    # eval needs the run dir alone: env, algo and device from config.json
    assert port_eval.main(["--model_dir", out_dir, "--n_episodes", "4",
                           "--no_gif"]) == 0
    assert (run_dir / "evaluate.png").exists()
    args = port_eval.parse(["--model_dir", out_dir, "--n_episodes", "6"])
    assert (args.algo, args.device, args.buffer_size) == ("DQN", "cpu",
                                                          2048)
    returns = port_eval.score(args)
    assert returns.shape == (6,) and ((returns >= 1) & (returns <= 500)).all()
    np.testing.assert_array_equal(returns, port_eval.score(args))


def test_eval_flags_override_config(tmp_path):
    """config.json < explicit flags, over the CLI's defaults: a run
    trained on the card is scored on the CPU with ``--device cpu``."""
    (tmp_path / "config.json").write_text(json.dumps(
        dict(algo="PPO", env_name="Pendulum-v1", device="cuda",
             trick=["tanh"], seed=3)))
    args = port_eval.parse(["--model_dir", str(tmp_path)])
    assert (args.algo, args.env_name, args.device, args.trick,
            args.num_envs) == ("PPO", "Pendulum-v1", "cuda", ["tanh"], 8)
    args = port_eval.parse(["--model_dir", str(tmp_path), "--device", "cpu",
                            "--trick", "--algo", "DQN"])
    assert (args.algo, args.device, args.trick) == ("DQN", "cpu", [])
    assert not hasattr(args, "seed")
    assert port_eval.parse(["--model_dir", str(tmp_path / "none")]).device \
        == "cuda"


def test_eval_envelope_preference(tmp_path):
    # --save_freq reads the episode count every chunk (one 256-step chunk
    # here), and learning starts late: ENVELOPE's learner step on the CPU
    # is 128 preferences x the batch
    out_dir = cpu_run(tmp_path, "--algo", "ENVELOPE", "--env_name",
                      "deep-sea-treasure-v0", "--max_episodes", "12",
                      "--num_envs", "4", "--buffer_size", "2048",
                      "--start_steps", "960", "--save_freq", "12")
    assert out_dir.endswith("ENVELOPE_1")
    assert port_eval.main(["--model_dir", out_dir, "--n_episodes", "4",
                           "--preference", "0.7", "0.3", "--no_gif"]) == 0
    assert os.path.exists(os.path.join(out_dir, "evaluate.png"))
    args = port_eval.parse(["--model_dir", out_dir, "--n_episodes", "4",
                            "--preference", "0.7", "0.3"])
    returns = port_eval.score(args)
    # the record's scalarization of deep-sea-treasure's (treasure, -1/step)
    assert returns.shape == (4,) and (returns <= 124.0 - 1).all()


def test_eval_recurrent_gif(tmp_path):
    out_dir = cpu_run(tmp_path, "--algo", "RMAPPO", "--env_name",
                      "simple_spread_v3", "--max_episodes", "24",
                      "--num_envs", "4", "--horizon", "100")
    assert port_eval.main(["--model_dir", out_dir, "--n_episodes", "4",
                           "--gif_seed", "3"]) == 0
    for name in ("evaluate.png", "evaluate.gif"):
        assert os.path.getsize(os.path.join(out_dir, name)) > 1000
    returns = port_eval.score(port_eval.parse(["--model_dir", out_dir,
                                               "--n_episodes", "4"]))
    assert returns.shape == (4, 3) and np.isfinite(returns).all()


def test_cli_fake_smac_state_route_and_save_freq(tmp_path):
    """--env_name fake-smac --use_state drives masked, state-augmented
    MAPPO end to end; --save_freq checkpoints mid-run."""
    out_dir = cpu_run(tmp_path, "--algo", "MAPPO", "--env_name",
                      "fake-smac", "--use_state", "--max_episodes", "16",
                      "--num_envs", "4", "--horizon", "100",
                      "--save_freq", "8")
    curve = np.load(os.path.join(out_dir, "MAPPO_seed_0.npy"))
    assert curve.shape == (16, 3) and np.isfinite(curve).all()
    args = cli_args(**json.loads(open(os.path.join(out_dir, "config.json"))
                                 .read()))
    env, algo = build(args)
    assert algo.cfg.masked and algo.cfg.state_dim == env.state_dim == 16
    state = load_checkpoint(os.path.join(out_dir, "checkpoint"),
                            algo.init(torch.Generator().manual_seed(5)))
    assert state.step == 4       # 400 env steps, 100 per iteration
