"""The port's data-parallel layer (``freerl_tpu_torch/distributed``) on
two CPU ranks with gloo, against the JAX package's ``shard_map`` on a
2-device slice of the conftest's CPU mesh.

Every rank-side check runs in ONE 2-rank launch (``tests/_torch_dp_worker.py
suite``, a module-scoped fixture); the tests below each assert one of its
results. The ranks rendezvous through a file in ``tmp_path``, so parallel
test workers share no port; every process group has a 60 s timeout and
the launch a 240 s one, so a mismatched collective fails instead of
hanging. JAX is imported inside the tests only: the ranks load torch
alone.

Tolerances: the normalizer at rtol 1e-5 / atol 1e-6 (the JAX test's);
``_merge_records`` and the multihost all-reduce exactly.
"""
import threading

import numpy as np
import pytest
import torch

from freerl_tpu_torch.distributed import dp
from freerl_tpu_torch.ops import _build
from tests._torch_dp_cases import launch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_suite")
    launch(d, "suite")
    return d, [torch.load(d / f"suite_{r}.pt", weights_only=False)
               for r in range(2)]


def jax_mesh2():
    from freerl_tpu.distributed.dp import make_mesh

    return make_mesh(2)


# ---------------------------------------------------------------------------
def test_multihost_all_reduce_matches_jax(suite):
    """Two processes join through ``multihost.initialize`` and average the
    gradient of ``w * sum(local data)``: the JAX shard_map pmean of the
    same data on 2 devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from freerl_tpu.distributed.dp import shard_map

    _, ranks = suite
    mesh = jax_mesh2()

    def grad_sync(xs):
        g = jax.grad(lambda w: jnp.sum(w * xs))(jnp.float32(1.0))
        return jax.lax.pmean(g, "dp")

    want = float(jax.jit(shard_map(grad_sync, mesh=mesh, in_specs=P("dp"),
                                   out_specs=P()))(
        jnp.arange(1.0, 5.0, dtype=jnp.float32)))
    assert want == 5.0
    assert [r["pmean"] for r in ranks] == [want, want]
    assert [r["hosts"] for r in ranks] == [2, 2]
    assert [r["primary"] for r in ranks] == [True, False]


def test_global_rms_matches_jax_and_one_device(suite):
    """``RunningMeanStd.update(axis_name)`` on two 8-row shards: JAX's
    sharded update, and one device's update on the 16 rows."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from freerl_tpu.core.normalization import RunningMeanStd as JaxRMS
    from freerl_tpu.distributed.dp import shard_map
    from freerl_tpu_torch.core.normalization import RunningMeanStd

    _, ranks = suite
    batch = np.random.default_rng(0).normal(size=(16, 3)).astype(
        np.float32) * 2.0 + 1.0
    mesh = jax_mesh2()
    jrms = JaxRMS.create((3,))
    with mesh:
        want = jax.jit(shard_map(
            lambda s, x: s.update(x, axis_name="dp"), mesh=mesh,
            in_specs=(P(), P("dp")), out_specs=P(), check_rep=False))(
            jrms, jnp.asarray(batch))
    one = RunningMeanStd.create((3,), "cpu").update(torch.from_numpy(batch))
    for r in ranks:
        mean, var, count = r["rms"]
        for got, jw, ow in ((mean, want.mean, one.mean),
                            (var, want.var, one.var)):
            np.testing.assert_allclose(got, np.asarray(jw), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(got, ow.numpy(), rtol=1e-5, atol=1e-6)
        assert count == float(want.count) == float(one.count)
    np.testing.assert_array_equal(ranks[0]["rms"][1], ranks[1]["rms"][1])


MERGE_CASES = {
    "scalar": ((5, 3), (7, 3), None),
    "agents": ((4, 6), (6, 6), 3),
    "overshoot": ((9, 2), (5, 5), None),      # counts past the record
    "empty": ((0, 0), (3, 3), None),
}


@pytest.mark.parametrize("name", list(MERGE_CASES))
def test_merge_records_matches_jax(name):
    from freerl_tpu.distributed.dp import _merge_records as jax_merge

    counts, (cap, steps_hi), agents = MERGE_CASES[name]
    rng = np.random.RandomState(len(name))
    shape = (2, cap) + ((agents,) if agents else ())
    rets = rng.randn(*shape).astype(np.float32)
    steps = np.sort(rng.randint(0, steps_hi, (2, cap)), axis=1)
    for max_eps in (4, 100):
        want = jax_merge(np.array(counts), rets, steps, max_eps)
        got = dp._merge_records(np.array(counts), rets, steps, max_eps)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_dqn_learns_cartpole_on_two_ranks(suite):
    """``train_offpolicy(mesh=)``, JAX's rule (``test_dp_driver.py``): at
    least 200 episodes, the last 30 above 40 and above twice the first 10;
    the merged record is the same on both ranks."""
    _, ranks = suite
    returns, info = ranks[0]["dqn"]["returns"], ranks[0]["dqn"]["info"]
    assert info["n_devices"] == 2
    assert len(returns) >= 200
    assert returns[-30:].mean() > 40, returns[-30:].mean()
    assert returns[-30:].mean() > 2 * returns[:10].mean()
    np.testing.assert_array_equal(returns, ranks[1]["dqn"]["returns"])
    assert np.all(returns == np.round(returns))    # CartPole pays 1 a step


def test_empty_record_when_no_episode_ends(suite):
    _, ranks = suite
    for r in ranks:
        assert r["no_episode"]["returns"].shape == (0,)
        assert r["no_episode"]["info"]["episodes"] == 0
        assert r["no_episode"]["info"]["env_steps"] == 32


@pytest.mark.parametrize("run", ["dqn", "td3", "matd3", "maddpg", "ppo"])
def test_params_bit_equal_across_ranks(suite, run):
    """Every replicated tensor (nets, targets, Adam moments, normalizer
    stats) bit-equal on both ranks after the run, and finite."""
    _, ranks = suite
    a, b = ranks[0][run]["flat"], ranks[1][run]["flat"]
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all()
    info = ranks[0][run].get("info")
    if info is not None:
        assert info.get("updates", info.get("iterations", 0)) > 0


@pytest.mark.parametrize("run", ["td3", "matd3"])
def test_host_int_delay_and_learn_cadence_agree(suite, run):
    """TD3's and MATD3's delay counters are host ints counted from the
    replicated learner steps: the same on both ranks, one per update."""
    _, ranks = suite
    steps = [r[run]["step"] for r in ranks]
    assert steps[0] == steps[1] == ranks[0][run]["updates"] > 0


def test_maddpg_record_keeps_the_agent_axis(suite):
    _, ranks = suite
    returns, info = ranks[0]["maddpg"]["returns"], ranks[0]["maddpg"]["info"]
    assert returns.shape == (16, 3) and info["episodes"] >= 16
    np.testing.assert_array_equal(returns, ranks[1]["maddpg"]["returns"])


def test_ppo_normalizers_replicated_and_checkpoint_global(suite):
    """obs_norm and reward_scaling fold the global batch (the counts hold
    both ranks' rows), and the checkpoint, written by rank 0 alone, holds
    the per-env running return of both ranks in rank order."""
    d, ranks = suite
    for x, y in zip(ranks[0]["ppo"]["stats"], ranks[1]["ppo"]["stats"]):
        np.testing.assert_array_equal(x, y)
    # three iterations of 32 steps of 8 envs, plus the reset fold
    assert ranks[0]["ppo"]["stats"][2] == pytest.approx(8 * (3 * 32 + 1),
                                                        abs=1e-3)
    saved = torch.load(d / "ckpt", weights_only=True)
    np.testing.assert_array_equal(
        saved["rew_scale"]["ret"].numpy(),
        np.concatenate([r["ppo"]["ret"] for r in ranks]))


def test_wrong_axis_name_and_recurrent_algo_refused(suite):
    _, ranks = suite
    assert "axis_name" in ranks[0]["wrong_axis"]
    assert "recurrent" in ranks[0]["recurrent"]


def test_dp_env_learner_step_metrics_agree(suite):
    _, ranks = suite
    m0, m1 = ranks[0]["step"]["metrics"], ranks[1]["step"]["metrics"]
    assert sorted(m0) == sorted(m1) and "mean_reward" in m0
    for k in m0:
        np.testing.assert_array_equal(m0[k], m1[k])
    np.testing.assert_array_equal(ranks[0]["step"]["flat"],
                                  ranks[1]["step"]["flat"])
    assert ranks[0]["step"]["buffer_size"] == 4


def test_unregistered_axis_and_foreign_mesh_refused():
    from freerl_tpu_torch.algos import DQN, DQNConfig
    from freerl_tpu_torch.core.types import DimInfo
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.train import OffPolicyConfig, train_offpolicy

    with pytest.raises(LookupError, match="make_mesh"):
        DQN(DimInfo(8, 4), DQNConfig(axis_name="no_such_axis"),
            device="cpu")
    env = make("CartPole-v1", device="cpu")
    algo = DQN(env.dim_info, DQNConfig(buffer_size=64), device="cpu")
    with pytest.raises(TypeError, match="make_mesh"):
        train_offpolicy(env, algo, OffPolicyConfig(), mesh=object())
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="process group"):
            dp.make_mesh(device="cpu")


def test_fold_in_gives_each_rank_its_own_seed():
    seeds = {dp.fold_in(s, r) for s in (0, 1) for r in range(4)}
    assert len(seeds) == 8 and dp.fold_in(3, 1) == dp.fold_in(3, 1)


def test_build_lock_builds_once(tmp_path, monkeypatch):
    """Two builds started together (two ranks) wait on the build lock:
    the fake compiler runs once, and the second finds the library fresh."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    log = tmp_path / "calls.txt"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    f"echo run >> {log}\n"
                    "sleep 0.5\n"
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'echo lib > "$2"\n')
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    reports = []
    threads = [threading.Thread(target=lambda: reports.append(
        _build.build_all(["k"]))) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert log.read_text().split() == ["run"]
    assert sorted(len(r) for r in reports) == [0, 1]
    assert (tmp_path / "build" / "libk.so").read_text() == "lib\n"


def test_torchrun_ranks_join_through_initialize(tmp_path):
    """Under ``torchrun`` (``--standalone``: a free port), ``initialize()``
    with no arguments joins from the launcher's environment."""
    import os
    import subprocess
    import sys

    script = tmp_path / "rank.py"
    script.write_text(
        "import torch, torch.distributed as dist\n"
        "from freerl_tpu_torch.distributed import multihost\n"
        "from freerl_tpu_torch.distributed.dp import make_mesh, psum\n"
        "assert multihost.initialize()\n"
        "mesh = make_mesh(axis='dp', device='cpu')\n"
        "total = psum(torch.tensor(float(mesh.rank + 1)), 'dp')\n"
        "open(f'r{mesh.rank}.txt', 'w').write(str(float(total)))\n"
        "dist.destroy_process_group()\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", str(script)], capture_output=True,
        text=True, env=env, cwd=str(tmp_path), timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert [(tmp_path / f"r{r}.txt").read_text() for r in range(2)] == [
        "3.0", "3.0"]
