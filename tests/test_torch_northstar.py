"""``scripts/torch_northstar.py`` against ``scripts/r5_northstar.py`` on the
CPU: the same env-step and update counts at a tiny point (they depend on no
RNG), the JAX row's keys plus the port's, the JAX script's defaults and
parity rule, and outputs only in the port's own tree (``results/torch/``):
the JAX package's ``results/northstar.json`` and ``DQN_fast_1_seed.npy`` stay
byte-identical."""
import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from scripts import r5_northstar
from scripts import torch_northstar

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FILES = ("results/northstar.json",
             "results/learning_curves/LunarLander-v2/DQN_fast_1_seed.npy")
PORT_KEYS = {"device", "card", "torch", "matmul_precision"}
# 12 chunks of 64 vector steps at 8 envs; learning starts past 4096 env
# steps, on vector step 513: 256 steps x 2 updates
POINT = (8, 2, 6144, 0)


@pytest.fixture(scope="module")
def rows():
    _, port = torch_northstar.run_point(*POINT, device="cpu")
    _, jax_row = r5_northstar.run_point(*POINT)
    return port, jax_row


def test_counts_equal_jax(rows):
    port, jax_row = rows
    assert (port["env_steps"], port["updates"]) == (
        jax_row["env_steps"], jax_row["updates"]) == (6144, 512)
    assert port["episodes"] > 0 and np.isfinite(port["final50"])


def test_row_keys_are_the_jax_rows_and_the_ports(rows):
    port, jax_row = rows
    assert set(port) == set(jax_row) | PORT_KEYS
    assert port["device"] == "cpu" and port["card"] is None
    assert port["torch"] == torch.__version__
    assert port["matmul_precision"] == torch.get_float32_matmul_precision()


def _digest(paths) -> dict:
    out = {}
    for p in paths:
        with open(p, "rb") as f:
            out[p] = hashlib.sha256(f.read()).hexdigest()
    return out


def _files(root) -> set:
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, fs in os.walk(root) for f in fs}


def test_defaults_and_parity_rule_are_the_jax_scripts(tmp_path, monkeypatch):
    """With no arguments but ``--device cpu``, from a working directory that
    holds a copy of the JAX artifacts: the JAX script's points, budget and
    seed; the fastest point whose final-1000 reaches 123.0 gives the tail
    (its last 5000 returns, (1, 5000) float32); everything is written under
    ``results/torch/``, and no JAX artifact changes, here or in the repo."""
    for rel in JAX_FILES:
        os.makedirs(tmp_path / os.path.dirname(rel), exist_ok=True)
        shutil.copy(os.path.join(ROOT, rel), tmp_path / rel)
    repo_before = _digest([os.path.join(ROOT, r) for r in JAX_FILES])
    copy_before = _digest([str(tmp_path / r) for r in JAX_FILES])
    monkeypatch.chdir(tmp_path)

    calls = []
    # (final1000, steady rate) per point: 2048x8 is the fastest at parity
    outcome = {(1024, 8): (150.0, 1.0), (2048, 8): (130.0, 3.0),
               (4096, 8): (100.0, 9.0), (4096, 16): (200.0, 2.0)}

    def fake_point(ne, upb, total, seed, device):
        calls.append((ne, upb, total, seed, device))
        final, rate = outcome[(ne, upb)]
        returns = np.arange(6000, dtype=np.float64) + ne * upb
        return returns, dict(final1000=final, steady_env_steps_per_s=rate)

    monkeypatch.setattr(torch_northstar, "run_point", fake_point)
    assert torch_northstar.main(["--device", "cpu"]) == 0
    assert calls == [(ne, upb, 150_000_000, 0, "cpu")
                     for ne, upb in outcome]
    tail = np.load(tmp_path / "results/torch/learning_curves/LunarLander-v2/"
                   "DQN_fast_1_seed.npy")
    assert tail.shape == (1, 5000) and tail.dtype == np.float32
    assert tail[0, 0] == 1000 + 2048 * 8 and tail[0, -1] == 5999 + 2048 * 8
    assert _files(tmp_path / "results") - set(
        os.path.relpath(r, "results") for r in JAX_FILES) == {
        "torch/northstar.json",
        "torch/learning_curves/LunarLander-v2/DQN_fast_1_seed.npy"}
    assert _digest([str(tmp_path / r) for r in JAX_FILES]) == copy_before
    assert _digest([os.path.join(ROOT, r) for r in JAX_FILES]) == repo_before


def test_tiny_run_writes_only_under_results_torch(tmp_path, monkeypatch):
    """A real run on the CPU at a tiny point, its parity bar lowered so the
    tail is saved: the row and the tail land under ``results/torch/``."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch_northstar, "PARITY_BAR", -np.inf)
    repo_before = _digest([os.path.join(ROOT, r) for r in JAX_FILES])
    assert torch_northstar.main(["--device", "cpu", "--points", "8x2",
                                 "--total_steps", "4608"]) == 0
    assert _files(tmp_path) == {
        "results/torch/northstar.json",
        "results/torch/learning_curves/LunarLander-v2/DQN_fast_1_seed.npy"}
    tail = np.load(tmp_path / "results/torch/learning_curves/LunarLander-v2/"
                   "DQN_fast_1_seed.npy")
    assert tail.shape[0] == 1 and tail.dtype == np.float32
    assert np.isfinite(tail).all()
    assert _digest([os.path.join(ROOT, r) for r in JAX_FILES]) == repo_before


def test_runs_without_a_card_only_on_request(tmp_path, monkeypatch):
    """No card: the default device refuses (exit 1, nothing written); only
    ``--device cpu`` runs."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert torch_northstar.main(["--points", "8x2",
                                 "--total_steps", "512"]) == 1
    assert not os.listdir(tmp_path)
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "torch_northstar.py"),
         "--points", "8x2", "--total_steps", "512"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 1 and "--device cpu" in proc.stderr
    assert not os.listdir(tmp_path)
