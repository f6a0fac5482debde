"""The port's measuring entry points on the CPU, at tiny sizes:
``freerl_tpu_torch/bench.py`` (its three benches, ``main``'s one JSON line
and its refusal to run without a card unless ``BENCH_FORCE_CPU`` asks for
the CPU), ``scripts/torch_per_bench.py``, and the import of those and of
``scripts/torch_dp_scaling.py`` with JAX and the JAX package blocked. The
bench's sizes never run here: they are the card's."""
import json
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch

from freerl_tpu.algos.dqn import DQN as JaxDQN
from freerl_tpu.algos.dqn import DQNConfig as JaxDQNConfig
from freerl_tpu.core.types import Transition as JaxTransition
from freerl_tpu_torch import bench
from freerl_tpu_torch.algos import DQN, DQNConfig
from freerl_tpu_torch.envs import make
from freerl_tpu_torch.train.loop import example_transition
from scripts import torch_per_bench

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_envs=8, device="cpu")


def test_bench_dqn_counts_its_steps():
    run = bench.bench_dqn(chunk=4, measure_chunks=1, **TINY)
    assert run.env_steps == 1 * 4 * 8
    assert math.isfinite(run.env_steps_per_s) and run.env_steps_per_s > 0
    assert run.env_steps_per_s == pytest.approx(run.env_steps / run.elapsed_s)


@pytest.mark.parametrize("which", ["ppo", "mappo"])
def test_bench_onpolicy_counts_its_steps(which):
    fn = bench.bench_ppo if which == "ppo" else bench.bench_mappo
    run = fn(steps_per_iter=4, measure_iters=2, **TINY)
    # the driver runs iterations in pairs: the 2 after the 2 warm ones
    assert run.env_steps == 2 * 4 * 8
    assert math.isfinite(run.env_steps_per_s) and run.env_steps_per_s > 0


@pytest.mark.parametrize("num_envs", [4096, 16384])
def test_replay_capacity_matches_jax(num_envs):
    """Both packages round the 1e6 ring up to a multiple of the env batch
    (1,003,520 rows at 4096 envs, 1,015,808 at 16,384)."""
    env = make("LunarLander-v2", device="cpu")
    ours = DQN(env.dim_info, DQNConfig(buffer_size=1_000_000,
                                       batch_size=256), device="cpu")
    jax_algo = JaxDQN(env.dim_info, JaxDQNConfig(buffer_size=1_000_000,
                                                 batch_size=256))
    example = JaxTransition(
        obs=jnp.zeros((8,)), action=jnp.zeros((), jnp.int32),
        reward=jnp.zeros(()), next_obs=jnp.zeros((8,)),
        done=jnp.zeros((), jnp.bool_), episode_done=jnp.zeros((), jnp.bool_))
    want = jax_algo.make_buffer(example, num_envs=num_envs).capacity
    got = ours.make_buffer(example_transition(env),
                           num_envs=num_envs).capacity
    assert got == want >= 1_000_000 and got % num_envs == 0


def _tiny_main(monkeypatch):
    monkeypatch.setattr(bench, "NUM_ENVS", 8)
    monkeypatch.setattr(bench, "CHUNK", 4)
    monkeypatch.setattr(bench, "MEASURE_CHUNKS", 1)
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)


def test_main_prints_one_json_line(monkeypatch, capsys):
    _tiny_main(monkeypatch)
    monkeypatch.setenv("BENCH_FORCE_CPU", "1")
    monkeypatch.setenv("BENCH_SKIP_EXTRA", "1")
    assert bench.main() == 0
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert line["metric"] == "dqn_lunarlander_env_steps_per_s"
    assert line["unit"] == "env_steps/s"
    assert line["vs_baseline"] is None and line["extra"] == {}
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert "device=cpu" in out.err and "num_envs=8 chunk=4" in out.err


def test_main_refuses_the_cpu_unless_forced(monkeypatch, capsys):
    _tiny_main(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() != 0
    out = capsys.readouterr()
    assert out.out == "" and "BENCH_FORCE_CPU" in out.err


def test_per_bench_on_the_cpu():
    out = torch_per_bench.run(capacity=1 << 10, batch=16, iters=20,
                              device="cpu")
    assert out["device"] == "cpu" and out["capacity"] == 1 << 10
    assert set(out["cycle_us"]) == {"tree", "cumsum"}
    assert all(math.isfinite(v) and v > 0 for v in out["cycle_us"].values())
    # one warm chunk and one timed chunk of 20 cycles; the CPU runs the
    # plain twin, so the kernel is never launched
    assert out["samples"] == {"tree": 40, "cumsum": 40}
    assert out["sumtree_launches"] == {"tree": 0, "cumsum": 0}


def test_new_entry_points_import_no_jax():
    code = (
        "import sys; sys.modules['jax'] = None; "
        "sys.modules['freerl_tpu'] = None; "
        "import freerl_tpu_torch.bench, scripts.torch_per_bench, "
        "scripts.torch_dp_scaling; "
        "import freerl_tpu_torch.train.golden; "
        "print(sorted(m for m, v in sys.modules.items() if v is not None "
        "and m.split('.')[0] in ('jax', 'jaxlib', 'freerl_tpu')))")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
