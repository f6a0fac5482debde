"""One rank of the port's data-parallel tests on the CPU (gloo).

Launched by ``tests/test_torch_distributed.py``, ``test_torch_dp_updates.py``
and ``test_torch_dp_onpolicy.py`` as ``python _torch_dp_worker.py <rank>
<world> <dir> <job>``. The rank joins the process group through
``multihost.initialize`` with a ``file://`` rendezvous in ``<dir>`` (no TCP
port, so parallel test workers cannot collide), builds the CPU mesh
``"dp"`` and runs ``<job>``, writing its results into ``<dir>``. It imports
torch and the port only, never JAX.

Jobs:
  updates  every case of ``<dir>/cases.pt``: the case's algo (pickled on
           the CPU, its config given ``axis_name="dp"`` here) is built,
           loaded from the case's checkpoint and called with this rank's
           inputs; the state is saved as ``out_<case>_<rank>.pt``;
  suite    the checks of ``test_torch_distributed.py`` (multihost, the
           normalizer, the three drivers, ``dp_env_learner_step``); results in
           ``suite_<rank>.pt``.
"""
import dataclasses
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _join(rank: int, world: int, d: str):
    import datetime

    from freerl_tpu_torch.distributed import multihost
    from freerl_tpu_torch.distributed.dp import make_mesh

    assert multihost.initialize(f"file://{d}/rendezvous", world, rank,
                                timeout=datetime.timedelta(seconds=60))
    return make_mesh(axis="dp", device="cpu",
                     timeout=datetime.timedelta(seconds=60))


def job_updates(mesh, d: str) -> None:
    import torch

    from freerl_tpu_torch.train.runio import load_checkpoint, save_checkpoint

    cases = torch.load(os.path.join(d, "cases.pt"), weights_only=False)
    for name, case in cases.items():
        algo = case["algo"]
        algo.cfg = dataclasses.replace(algo.cfg, axis_name="dp")
        state = load_checkpoint(case["state"],
                                algo.init(torch.Generator().manual_seed(0)))
        for method, args, kwargs in case["calls"][mesh.rank]:
            state = getattr(algo, method)(state, *args, **kwargs)[0]
        save_checkpoint(os.path.join(d, f"out_{name}_{mesh.rank}.pt"), state)


def _flat(state) -> "torch.Tensor":
    """Every replicated float tensor of an algo state, flattened (the
    per-env leaves, which differ by rank, left out)."""
    import torch

    from freerl_tpu_torch.distributed.dp import (_get, per_env_paths,
                                                 state_tensors)

    per_env = {id(_get(state, p)) for p in per_env_paths(state)}
    return torch.cat([t.detach().reshape(-1).double()
                      for t in state_tensors(state)
                      if t.is_floating_point() and id(t) not in per_env])


def job_suite(mesh, d: str) -> None:
    import numpy as np
    import torch

    from freerl_tpu_torch.algos import (DQN, MADDPG, MATD3, PPO, RMAPPO,
                                        TD3, DQNConfig, MADDPGConfig,
                                        PPOConfig, RMAPPOConfig, TD3Config)
    from freerl_tpu_torch.core.normalization import RunningMeanStd
    from freerl_tpu_torch.distributed import dp_env_learner_step, multihost
    from freerl_tpu_torch.distributed.dp import pmean_grads
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.train import (MARLConfig, OffPolicyConfig,
                                        OnPolicyConfig, train_marl,
                                        train_offpolicy, train_onpolicy)

    r = mesh.rank
    out = {"hosts": multihost.hosts(), "primary": multihost.is_primary()}

    # multihost: the gradient of w * sum(local data), averaged
    data = torch.arange(1.0, 5.0)[2 * r:2 * r + 2]
    w = torch.ones((), requires_grad=True)
    torch.sum(w * data).backward()
    pmean_grads([w], "dp")
    out["pmean"] = float(w.grad)

    # the normalizer's global-batch update
    batch = np.random.default_rng(0).normal(size=(16, 3)).astype(
        np.float32) * 2.0 + 1.0
    rms = RunningMeanStd.create((3,), "cpu").update(
        torch.from_numpy(batch[8 * r:8 * r + 8]), axis_name="dp")
    out["rms"] = [rms.mean.numpy(), rms.var.numpy(), float(rms.count)]

    # DQN learns CartPole through train_offpolicy(mesh=)
    env = make("CartPole-v1", device="cpu")
    algo = DQN(env.dim_info, DQNConfig(buffer_size=20_000, batch_size=64,
                                       axis_name="dp"), device="cpu")
    cfg = OffPolicyConfig(num_envs=16, max_episodes=250, start_steps=500,
                          updates_per_burst=8, chunk_size=128)
    state, returns, info = train_offpolicy(env, algo, cfg, mesh=mesh)
    out["dqn"] = dict(returns=returns, info=info, flat=_flat(state).numpy())

    # two vector steps: no episode ends on either rank
    _, returns, info = train_offpolicy(env, algo, OffPolicyConfig(
        num_envs=16, chunk_size=2, max_env_steps=32, start_steps=10**6),
        mesh=mesh)
    out["no_episode"] = dict(returns=returns, info=info)

    # a config without the mesh's axis is refused, as in the JAX package
    plain = DQN(env.dim_info, DQNConfig(buffer_size=1024, batch_size=16),
                device="cpu")
    try:
        train_offpolicy(env, plain, OffPolicyConfig(num_envs=8,
                                                    max_episodes=4),
                        mesh=mesh)
        out["wrong_axis"] = "no error"
    except AssertionError as e:
        out["wrong_axis"] = str(e)

    # TD3's host-int delay and the learn cadence agree across ranks
    lunar = make("LunarLanderContinuous-v2", device="cpu")
    td3 = TD3(lunar.dim_info, TD3Config(buffer_size=4096, batch_size=32,
                                        hidden=(16, 16), axis_name="dp"),
              device="cpu")
    state, _, info = train_offpolicy(lunar, td3, OffPolicyConfig(
        num_envs=8, start_steps=64, chunk_size=16, max_env_steps=8 * 48,
        max_episodes=10**6), mesh=mesh)
    out["td3"] = dict(step=state.step, updates=info["updates"],
                      flat=_flat(state).numpy())

    # MATD3's host-int delay agrees across ranks too
    spread = make("simple_spread_v3", device="cpu")
    matd3 = MATD3(spread, MADDPGConfig(buffer_size=4096, batch_size=32,
                                       hidden=(16, 16), axis_name="dp"),
                  device="cpu")
    state, _, info = train_marl(spread, matd3, MARLConfig(
        num_envs=8, max_env_steps=8 * 40, max_episodes=10**6,
        start_steps=100, chunk_size=20, host_sync_every=1), mesh=mesh)
    out["matd3"] = dict(step=state.step, updates=info["updates"],
                        flat=_flat(state).numpy())

    # MADDPG through train_marl(mesh=)
    maddpg = MADDPG(spread, MADDPGConfig(buffer_size=4096, batch_size=32,
                                         hidden=(16, 16), axis_name="dp"),
                    device="cpu")
    state, returns, info = train_marl(spread, maddpg, MARLConfig(
        num_envs=8, max_episodes=16, start_steps=100, chunk_size=25,
        host_sync_every=1), mesh=mesh)
    out["maddpg"] = dict(returns=returns, info=info,
                         flat=_flat(state).numpy())

    # PPO with the three normalizer tricks through train_onpolicy(mesh=),
    # with a checkpoint every iteration
    cart = make("CartPole-v1", device="cpu")
    ppo = PPO(cart.dim_info, PPOConfig(horizon=256, num_envs=8,
                                       minibatch_size=32, K_epochs=2,
                                       hidden=(16, 16), adv_norm=True,
                                       obs_norm=True, reward_scaling=True,
                                       axis_name="dp"), device="cpu")
    state, returns, info = train_onpolicy(cart, ppo, OnPolicyConfig(
        num_envs=8, horizon=256, max_env_steps=256 * 3, max_episodes=10**6,
        checkpoint_dir=d, checkpoint_every=1), mesh=mesh)
    out["ppo"] = dict(returns=returns, info=info, flat=_flat(state).numpy(),
                      stats=[state.obs_rms.mean.numpy(),
                             state.obs_rms.var.numpy(),
                             float(state.obs_rms.count),
                             state.rew_scale.stats.var.numpy(),
                             float(state.rew_scale.stats.count)],
                      ret=state.rew_scale.ret.numpy())

    # a recurrent algo is refused
    rmappo = RMAPPO(spread, RMAPPOConfig(axis_name="dp"), device="cpu")
    try:
        train_onpolicy(spread, rmappo, OnPolicyConfig(num_envs=8), mesh=mesh)
        out["recurrent"] = "no error"
    except AssertionError as e:
        out["recurrent"] = str(e)

    # one step of dp_env_learner_step
    lunar_d = make("LunarLander-v2", device="cpu")
    dqn = DQN(lunar_d.dim_info, DQNConfig(per=True, per_sampler="tree",
                                          buffer_size=1024, batch_size=8,
                                          hidden=(16,), axis_name="dp"),
              device="cpu")
    init_fn, step_fn = dp_env_learner_step(lunar_d, dqn, mesh, 4)
    carry = init_fn(3)
    carry, metrics = step_fn(carry)
    out["step"] = dict(metrics={k: v.numpy() for k, v in metrics.items()},
                       flat=_flat(carry["algo_state"]).numpy(),
                       buffer_size=int(carry["buffer"].size))

    torch.save(out, os.path.join(d, f"suite_{r}.pt"))


JOBS = {"updates": job_updates, "suite": job_suite}


def main() -> int:
    rank, world, d, job = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        JOBS[job](_join(rank, world, d), d)
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
