"""The port's ``train/golden.py`` against the JAX package's: the same
specs and gates, ``check_all`` rows equal on the same artifacts, and
``regenerate`` through the port's CLI on the CPU into ``tmp_path`` (no
test writes into ``results/learning_curves/``). The port's curves have a
tree of their own: by default it lies outside the JAX package's
``results/learning_curves/``, which a regenerate leaves as it was."""
import dataclasses
import hashlib
import importlib.util
import os
import shutil
import sys

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
    """Pointed at the JAX package's artifacts, the port's gates give the
    JAX rows; with its own defaults, no JAX artifact is read as ours."""
    monkeypatch.setattr(golden, "REF_ROOT", jax_golden.REF_ROOT)
    own = golden.check_all()
    monkeypatch.setattr(golden, "OURS_ROOT", jax_golden.OURS_ROOT)
    rows, want = golden.check_all(), jax_golden.check_all()
    assert rows == want
    assert len(rows) == len(golden.SPECS) + len(golden.SCALAR_GATES)
    assert not [r for r in rows if r["status"] == "FAIL"]
    read = [(r["env"], r["algo"]) for r in own if r["ours"] is not None]
    assert not read, f"read as the port's: {read}"


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


def _tree_digest(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


def test_default_root_leaves_the_jax_curves_alone(tmp_path, monkeypatch):
    """C6: the port's default curves root lies outside the JAX package's
    ``results/learning_curves/``; a default ``regenerate``, run from a copy
    of ``golden.py`` in a temporary repo root beside a copy of that tree,
    writes its stack under the port's root and leaves the tree as it
    was."""
    jax_root = os.path.realpath(jax_golden.OURS_ROOT)
    ours = os.path.realpath(golden.OURS_ROOT)
    assert os.path.commonpath([ours, jax_root]) != jax_root

    src = os.path.join(tmp_path, "freerl_tpu_torch", "train", "golden.py")
    os.makedirs(os.path.dirname(src))
    shutil.copy(golden.__file__, src)
    curves = os.path.join(tmp_path, "results", "learning_curves")
    shutil.copytree(jax_root, curves)
    before = _tree_digest(curves)
    spec = importlib.util.spec_from_file_location("_golden_copy", src)
    copy = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, copy)
    spec.loader.exec_module(copy)
    assert os.path.realpath(copy.OURS_ROOT).startswith(str(tmp_path))
    copy.regenerate(copy.GoldenSpec(*dataclasses.astuple(_spec())),
                    results_root=str(tmp_path / "runs"), device="cpu")
    assert _tree_digest(curves) == before
    stacked = np.load(os.path.join(copy.OURS_ROOT, "CartPole-v1",
                                   "DQN_1_seed.npy"))
    assert stacked.shape[0] == 1 and stacked.shape[1] >= 25
