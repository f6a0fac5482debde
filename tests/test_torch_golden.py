"""The port's ``train/golden.py`` against the JAX package's: the same
specs and gates, ``check_all`` rows equal on the same artifacts, and
``regenerate`` through the port's CLI on the CPU into ``tmp_path`` (no
test writes into ``results/learning_curves/``)."""
import dataclasses

import numpy as np
import torch

from freerl_tpu.train import golden as jax_golden
from freerl_tpu_torch.train import golden

torch.set_num_threads(1)


def test_specs_and_gates_are_the_jax_packages():
    assert [dataclasses.astuple(s) for s in golden.SPECS] == [
        dataclasses.astuple(s) for s in jax_golden.SPECS]
    assert golden.SCALAR_GATES == jax_golden.SCALAR_GATES


def test_check_all_rows_equal_jax(monkeypatch):
    monkeypatch.setattr(golden, "REF_ROOT", jax_golden.REF_ROOT)
    rows, want = golden.check_all(), jax_golden.check_all()
    assert rows == want
    assert len(rows) == len(golden.SPECS) + len(golden.SCALAR_GATES)
    assert not [r for r in rows if r["status"] == "FAIL"]


def _spec():
    return golden.GoldenSpec(
        "CartPole-v1", "DQN_1_seed",
        "DQN_file/learning_curves/CartPole-v1/DQN_3_seed.npy",
        regen=("--algo", "DQN", "--env_name", "CartPole-v1",
               "--max_episodes", "25", "--num_envs", "4",
               "--buffer_size", "2048", "--seed", "{seed}"),
        regen_seeds=(0,))


def test_regenerate_through_the_port_cli(tmp_path, monkeypatch):
    """A 25-episode CartPole recipe on the CPU: a (1, >=25) stack and its
    plot under ``OURS_ROOT``; without matplotlib, the stack alone."""
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path))
    path = golden.regenerate(_spec(), results_root=str(tmp_path / "runs"),
                             device="cpu")
    stacked = np.load(tmp_path / "CartPole-v1" / "DQN_1_seed.npy")
    assert stacked.shape[0] == 1 and stacked.shape[1] >= 25
    assert np.isfinite(stacked).all()
    assert path.endswith(".png")
    monkeypatch.setattr(golden, "_has_matplotlib", lambda: False)
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path / "plain"))
    path = golden.regenerate(_spec(), results_root=str(tmp_path / "runs"),
                             device="cpu")
    assert path.endswith("DQN_1_seed.npy")
    assert np.load(path).shape[0] == 1
