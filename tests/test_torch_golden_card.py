"""``scripts/torch_golden_card.py`` on the CPU: its jobs (the north-star
point and one CLI run per seed of a ``golden.JAX_PARITY`` row, with the
row's recipe unchanged), one card per job, the seeds stacked under the
port's curves root, the parity gate, and no child left when it exits, also
when a deadline cuts the jobs."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from chip_smoke import child_processes
from freerl_tpu_torch.train import golden
from scripts import torch_golden_card as card

torch.set_num_threads(1)

TINY = golden.GoldenSpec(
    "CartPole-v1", "DQN_1_seed", "CartPole-v1/DQN_1_seed.npy",
    regen=("--algo", "DQN", "--env_name", "CartPole-v1",
           "--max_episodes", "25", "--num_envs", "4",
           "--buffer_size", "2048", "--seed", "{seed}"),
    regen_seeds=(3,))


def test_jobs_of_the_two_rows():
    """The north star at 150M and seed 0; the golden row's three seeds run
    the JAX package's recipe through the port's CLI on the card."""
    jobs = card.make_jobs("4096x8", ["LunarLander-v2/DQN_3_seed"],
                          150_000_000, "cuda", "res")
    assert [j["name"] for j in jobs] == [
        "northstar_4096x8"] + [f"LunarLander-v2_DQN_3_seed_seed_{s}"
                               for s in (0, 10, 100)]
    ns = jobs[0]["argv"]
    assert ns[1].endswith(os.path.join("scripts", "torch_northstar.py"))
    assert ns[2:] == ["--points", "4096x8", "--total_steps", "150000000",
                      "--seed", "0", "--device", "cuda",
                      "--out", os.path.join("res", "northstar.json"),
                      "--curves_root", golden.OURS_ROOT]
    spec = golden.JAX_PARITY[1]
    for job, seed in zip(jobs[1:], (0, 10, 100)):
        assert job["argv"][:3] == [sys.executable, "-m",
                                   "freerl_tpu_torch.cli"]
        assert job["argv"][3:] == golden.regen_argv(spec, seed, "res",
                                                    "cuda")
        assert job["row"] == "LunarLander-v2/DQN_3_seed"


def test_jobs_of_chosen_seeds_once_a_seed_file(tmp_path, monkeypatch):
    """``--seeds`` keeps a row's jobs to those seeds; rows of one recipe
    share their seeds' files, so a seed is run once for all of them, and a
    kept seed not at all."""
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path))
    keys = ["LunarLander-v2/DQN_3_seed", "LunarLander-v2/DQN_16_seed@jax_head",
            "LunarLander-v2/DQN_48_seed@jax_head"]
    jobs = card.make_jobs(None, keys, 1, "cuda", "r", True,
                          [100, 15, 46, 47])
    assert [(j["row"], j["seed"]) for j in jobs] == [
        (keys[0], 100), (keys[2], 15), (keys[2], 46)]
    jobs = card.make_jobs(None, keys, 1, "cuda", "r", True)
    assert [j["seed"] for j in jobs] == list(golden.DQN_LL_SEEDS48)
    assert card.main(["--seeds", "1", "--device", "cpu", "--log_dir",
                      str(tmp_path / "log"), "--deadline", "0",
                      keys[1]]) == 1


def test_unknown_or_recipe_less_rows_are_refused():
    with pytest.raises(KeyError):
        card.make_jobs(None, ["LunarLander-v2/PPO_9_seed"], 1, "cuda", "r")
    with pytest.raises(ValueError):
        card.make_jobs(None, [card.NORTHSTAR], 1, "cuda", "r")


@pytest.mark.parametrize("n_cards,want", [(4, [[0], [1], [2], [3]]),
                                          (1, [[0, 1, 2, 3]]),
                                          (2, [[0, 2], [1, 3]])])
def test_jobs_are_dealt_one_card_each(n_cards, want):
    assert card.deal(list(range(4)), n_cards) == want


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    monkeypatch.setattr(golden, "JAX_PARITY", golden.JAX_PARITY + [TINY])
    monkeypatch.setattr(golden, "OURS_ROOT", str(tmp_path / "curves"))
    return ["--device", "cpu", "--northstar", "8x2", "--total_steps",
            "4608", "CartPole-v1/DQN_1_seed", "--results_root",
            str(tmp_path / "res"), "--log_dir", str(tmp_path / "logs")]


def test_cpu_run_stacks_and_gates(tiny, tmp_path, capsys):
    assert card.main(tiny) == 0
    out = capsys.readouterr().out.strip().splitlines()
    stack = json.loads(next(ln for ln in out if ln.startswith('{"stack"')))
    assert stack["stack"] == "CartPole-v1/DQN_1_seed"
    assert stack["seeds"] == [3] and stack["shape"][0] == 1
    saved = np.load(tmp_path / "curves" / "CartPole-v1" / "DQN_1_seed.npy")
    assert saved.shape == tuple(stack["shape"]) and np.isfinite(saved).all()
    last = json.loads(out[-1])
    assert [(j["name"], j["rc"]) for j in last["jobs"]] == [
        ("northstar_8x2", 0), ("CartPole-v1_DQN_1_seed_seed_3", 0)]
    status = {r["key"]: r["status"] for r in last["parity"]}
    assert status == {**{golden.row_key(r): "missing"
                         for r in golden.JAX_PARITY},
                      "CartPole-v1/DQN_1_seed": "no-reference"}
    assert last["left_running"] == {}
    logs = set(os.listdir(tmp_path / "logs"))
    assert {"northstar_8x2.log", "CartPole-v1_DQN_1_seed_seed_3.log",
            "northstar.json", "curves"} <= logs
    curves = tmp_path / "logs" / "curves" / "CartPole-v1"
    assert {"DQN_1_seed.npy", "provenance.json"} <= set(os.listdir(curves))
    assert os.listdir(curves / "seeds") == ["DQN_seed_3.npy"]
    rows = json.load(open(tmp_path / "res" / "northstar.json"))["rows"]
    assert rows[0]["env_steps"] == 4608 and rows[0]["updates"] == 128
    assert not child_processes()


def test_deadline_cuts_and_stops_every_job(tiny, tmp_path, capsys):
    assert card.main(tiny + ["--deadline", "0"]) == 1
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [j["rc"] for j in last["jobs"]] == [None, None]
    assert all(r["status"] in ("missing", "no-reference")
               for r in last["parity"])
    assert not os.path.exists(tmp_path / "curves")
    assert not child_processes()
