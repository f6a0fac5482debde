"""Data-parallel actor-learner over ``torch.distributed`` (counterpart:
``freerl_tpu/distributed/dp.py``).

The JAX package drives an n-device mesh from one process inside a
``shard_map``. The port runs ONE PROCESS PER DEVICE, DDP's layout: every
rank runs the same driver on its ``num_envs / n`` env slice with a
rank-local replay, parameters are replicated, and the algos all-reduce
their gradients over the process group that their config's ``axis_name``
selects (``cfg.axis_name = "dp"`` resolves to the mesh that
:func:`make_mesh` registered under ``"dp"``). The all-reduce sits where
the JAX package has its ``pmean``: after the gradient, before any clip or
optimizer step.

What is drawn per rank and what is shared follows the JAX package:
- the env, exploration and learner draws fold the rank in (JAX folds the
  device index into those keys), so each rank has its own generator,
  seeded with :func:`fold_in` of the seed and the rank;
- the algo is built from the seed on every rank and then broadcast from
  rank 0 (DDP's idiom; JAX uses one key on all devices);
- the on-policy update's draws are NOT folded: they come from a generator
  seeded alike on every rank, so PPO's permutations and HAPPO's order
  agree.

Every rank issues the same collectives in the same order: the learner's
cadence and the delays are host ints counted from replicated counters, and
the lazy episode sync all-reduces the counters at the same chunk on every
rank, so all ranks take the same ``break``. Every process group carries a
timeout, so a mismatched collective fails instead of hanging.

Of gloo's collectives only ``all_reduce`` and ``broadcast`` take CUDA
tensors, so this module uses those two alone; a gather is an all-reduce
of a zero buffer that each rank writes its own row into.

Entry points: :func:`make_mesh`, the drivers
:func:`train_offpolicy_sharded`, :func:`train_marl_sharded` and
:func:`train_onpolicy_sharded` (``train_offpolicy``, ``train_marl`` and
``train_onpolicy`` delegate here with ``mesh=``), and
:func:`dp_env_learner_step`, one data-parallel step for step-level checks.
"""
from __future__ import annotations

import dataclasses
import datetime
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from freerl_tpu_torch.envs.base import Env, vec_reset

DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)

# per-env leaves of an algo state: they shard with the env axis where
# everything else is replicated (JAX ``_algo_state_specs``): PPO's and
# MAPPO's reward_scaling running return, and the OU noise state of DDPG,
# TD3 and SAC
PER_ENV_LEAVES = (("rew_scale", "ret"), ("ou_state",))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A data-parallel axis over ``size`` ranks, one device each.

    ``axis_names`` is ``(axis,)``, as a ``jax.sharding.Mesh``'s; ``device``
    is this rank's device and ``group`` the process group its collectives
    run on."""

    group: object
    axis_names: tuple
    size: int
    rank: int
    device: torch.device

    @property
    def is_primary(self) -> bool:
        return self.rank == 0


_MESHES: dict[str, Mesh] = {}


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              backend: Optional[str] = None, device="cuda",
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """This rank's view of a data-parallel mesh over every rank of the
    default process group (``multihost.initialize`` or
    ``torch.distributed.init_process_group`` joins it first), registered
    under ``axis`` so that a config's ``axis_name=axis`` finds it.

    ``device="cuda"`` gives rank r the card ``cuda:{r % device_count}``;
    ``device="cpu"`` runs the rank on the CPU. ``backend`` defaults to
    ``nccl`` for CUDA devices and ``gloo`` for the CPU. NCCL refuses two
    ranks on one card, so with more ranks than cards ``backend="gloo"``
    must be asked for by name. ``n_devices``, when given, must equal the
    world size (one process per device)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no default process group; join one first with "
            "freerl_tpu_torch.distributed.multihost.initialize(...) or "
            "torch.distributed.init_process_group(...)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"make_mesh: n_devices={n_devices} but the process group has "
            f"{world} ranks; the port runs one process per device")
    device = torch.device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if device.index is None:
            device = torch.device("cuda", rank % count)
        backend = backend or "nccl"
        if backend == "nccl" and world > count:
            raise ValueError(
                f"make_mesh: {world} ranks on {count} card(s); NCCL takes one "
                f"card per rank, so ask for backend='gloo' by name to put "
                f"several ranks on one card")
        torch.cuda.set_device(device)
    else:
        backend = backend or "gloo"
        if backend == "nccl":
            raise ValueError("make_mesh: nccl needs CUDA devices")
    group = dist.new_group(list(range(world)), backend=backend,
                           timeout=timeout)
    mesh = Mesh(group=group, axis_names=(axis,), size=world, rank=rank,
                device=device)
    _MESHES[axis] = mesh
    return mesh


def mesh_of(axis_name: str) -> Mesh:
    """The mesh registered under ``axis_name``; an axis no mesh was made
    for raises rather than skipping the reduction."""
    mesh = _MESHES.get(axis_name)
    if mesh is None:
        raise LookupError(
            f"axis_name {axis_name!r} names no process group: build one on "
            f"every rank with freerl_tpu_torch.distributed.make_mesh("
            f"axis={axis_name!r}) first")
    return mesh


def release(mesh: Mesh) -> None:
    """Unregister ``mesh`` and destroy its process group."""
    if _MESHES.get(mesh.axis_names[0]) is mesh:
        del _MESHES[mesh.axis_names[0]]
    dist.destroy_process_group(mesh.group)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def _all_reduce(x: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM):
    dist.all_reduce(x, op=op, group=mesh.group)
    return x


def psum(x: torch.Tensor, axis_name: Optional[str]) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis_name`` (a new tensor);
    ``x`` itself where ``axis_name`` is None."""
    if axis_name is None:
        return x
    return _all_reduce(x.clone(), mesh_of(axis_name))


def pmean(x, axis_name: Optional[str]):
    """The mean over the ranks of ``axis_name`` of a tensor, or of a group
    of tensors (a list) in ONE flattened ``all_reduce``: the sum divided
    by the size, as XLA's ``pmean`` is a psum over n. A group comes back
    as views of one flat buffer. ``x`` itself where ``axis_name`` is
    None."""
    if axis_name is None:
        return x
    if isinstance(x, torch.Tensor):
        return pmean([x], axis_name)[0]
    mesh = mesh_of(axis_name)
    xs = list(x)
    if not xs:
        return xs
    flat = _all_reduce(torch.cat([t.reshape(-1) for t in xs]), mesh)
    flat.div_(mesh.size)
    parts = torch.split(flat, [t.numel() for t in xs])
    return [p.view(t.shape) for p, t in zip(parts, xs)]


def pmax(x: torch.Tensor, axis_name: Optional[str]) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks of ``axis_name``."""
    if axis_name is None:
        return x
    return _all_reduce(x.clone(), mesh_of(axis_name), dist.ReduceOp.MAX)


def pmean_grads(params: Sequence[torch.Tensor],
                axis_name: Optional[str]) -> None:
    """Replace the ``.grad`` of ``params`` by its mean over the ranks of
    ``axis_name``, in one all-reduce; nothing where it is None."""
    if axis_name is None:
        return
    with_grad = [p for p in params if p.grad is not None]
    for p, g in zip(with_grad, pmean([p.grad for p in with_grad],
                                     axis_name)):
        p.grad = g


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``(size,) + x.shape``: every rank's ``x`` in rank order, through an
    all-reduce of a zero buffer that each rank writes its row into (gloo
    gathers no CUDA tensor)."""
    out = torch.zeros((mesh.size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    out[mesh.rank] = x
    return _all_reduce(out, mesh)


def fold_in(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s own draws, ``seed`` and ``rank`` mixed
    by numpy's ``SeedSequence`` (the role of ``jax.random.fold_in``)."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(
        1, np.uint64)[0] >> 1)


def rank_generator(seed: int, mesh: Mesh) -> torch.Generator:
    g = torch.Generator(device=mesh.device)
    g.manual_seed(fold_in(seed, mesh.rank))
    return g


# ---------------------------------------------------------------------------
# algo state across ranks
# ---------------------------------------------------------------------------
def state_tensors(x) -> list[torch.Tensor]:
    """Every tensor of an algo state, in a fixed order: module parameters
    and buffers, optimizer state, tensor fields, through dataclasses,
    lists, tuples and dicts."""
    if isinstance(x, torch.nn.Module):
        return [*x.parameters(), *x.buffers()]
    if isinstance(x, torch.optim.Optimizer):
        return [v for group in x.param_groups for p in group["params"]
                for _, v in sorted(x.state.get(p, {}).items())
                if isinstance(v, torch.Tensor)]
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in state_tensors(v)]
    return []


@torch.no_grad()
def broadcast_state(state, mesh: Mesh) -> None:
    """Overwrite every tensor of ``state`` with rank 0's, in place."""
    for t in state_tensors(state):
        dist.broadcast(t.data, src=0, group=mesh.group)


def _get(state, path):
    for name in path:
        state = getattr(state, name, None)
    return state


def _replace(state, path, value):
    if len(path) == 1:
        return dataclasses.replace(state, **{path[0]: value})
    inner = getattr(state, path[0])
    return dataclasses.replace(
        state, **{path[0]: _replace(inner, path[1:], value)})


def per_env_paths(state) -> list[tuple]:
    """The per-env leaves (``PER_ENV_LEAVES``) this state has."""
    return [p for p in PER_ENV_LEAVES
            if isinstance(_get(state, p), torch.Tensor)]


def shard_per_env(state, mesh: Mesh):
    """Keep this rank's rows of every per-env leaf: the contiguous
    ``1/size`` of its leading axis, as ``PartitionSpec(axis)`` splits it."""
    for path in per_env_paths(state):
        leaf = _get(state, path)
        n = leaf.shape[0] // mesh.size
        state = _replace(state, path,
                         leaf[mesh.rank * n:(mesh.rank + 1) * n].clone())
    return state


def save_checkpoint_sharded(path: str, state, mesh: Mesh) -> None:
    """``save_checkpoint`` under a mesh: the per-env leaves are gathered in
    rank order (the saved tree has the global ``(num_envs, ...)`` layout)
    and the primary rank alone writes. Every rank must call it."""
    from freerl_tpu_torch.train.runio import save_checkpoint

    for p in per_env_paths(state):
        g = all_gather(_get(state, p), mesh)
        state = _replace(state, p, g.reshape((-1,) + tuple(g.shape[2:])))
    if mesh.is_primary:
        save_checkpoint(path, state)


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------
def _merge_records(counts, rets, steps, max_episodes):
    """Merge per-device chronological episode records into one curve.

    Orders episodes by (completion vector-step, device) so the merged
    artifact matches the single-device drivers' chronological format.
    ``rets`` is (n_dev, cap) or (n_dev, cap, A).
    """
    counts = np.asarray(counts)
    rets = np.asarray(rets)
    steps = np.asarray(steps)
    rows, vals = [], []
    for d in range(len(counts)):
        # lazy host-sync lets the loop overshoot max_episodes, so the
        # counter can exceed the record capacity; slots past it were
        # dropped at write time (mode="drop")
        n = min(int(counts[d]), rets.shape[1])
        rows.append(np.stack([steps[d, :n], np.full(n, d)], axis=1))
        vals.append(rets[d, :n])
    keys_m = np.concatenate(rows, axis=0) if rows else np.zeros((0, 2))
    vals_m = (np.concatenate(vals, axis=0) if vals
              else np.zeros((0,) + rets.shape[2:]))
    order = np.lexsort((keys_m[:, 1], keys_m[:, 0]))
    return vals_m[order][:max_episodes]


def merged_returns(c, mesh: Mesh, record_cap: int, max_episodes: int):
    """Every rank's episode record of carry ``c`` gathered and merged by
    (completion vector-step, rank); returns ``(returns, counts)``, the same
    on every rank. Only the slots the fullest rank wrote travel."""
    counts = all_gather(c.ep_counter, mesh).cpu().numpy()
    n = min(int(counts.max()), record_cap)
    if n == 0:
        return (np.zeros((0,) + tuple(c.episode_returns.shape[1:]),
                         np.float32), counts)
    rets = all_gather(c.episode_returns[:n], mesh).cpu().numpy()
    steps = all_gather(c.episode_steps[:n], mesh).cpu().numpy()
    return (_merge_records(counts, rets, steps, max_episodes)
            .astype(np.float32), counts)


def _mesh_axis(mesh, axis: Optional[str]) -> str:
    """``axis``, or the mesh's own where it is None; anything but a
    :class:`Mesh` is refused."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a freerl_tpu_torch.distributed.dp.Mesh "
                        f"from make_mesh, got {type(mesh).__name__}")
    return mesh.axis_names[0] if axis is None else axis


def _check_axis(algo, axis: str, what: str) -> None:
    aname = getattr(algo.cfg, "axis_name", None)
    assert aname == axis, (
        f"algo config must carry axis_name={axis!r} so {what} (got "
        f"{aname!r})")


def _start_state(algo, seed: int, mesh: Mesh):
    """The algo built from ``seed`` (the same on every rank), broadcast
    from rank 0, with this rank's rows of its per-env leaves; and the
    generator it was built from, which goes on alike on every rank."""
    shared = torch.Generator(device=mesh.device)
    shared.manual_seed(seed)
    state = algo.init(shared)
    broadcast_state(state, mesh)
    return shard_per_env(state, mesh), shared


def _envs_per_rank(num_envs: int, mesh: Mesh) -> int:
    if num_envs % mesh.size:
        raise ValueError(f"num_envs={num_envs} does not split over "
                         f"{mesh.size} ranks")
    return num_envs // mesh.size


def _sync_episodes(c, mesh: Mesh) -> int:
    return int(_all_reduce(c.ep_counter.clone(), mesh))


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------
def train_offpolicy_sharded(env: Env, algo, cfg, mesh: Mesh,
                            axis: Optional[str] = None,
                            on_chunk: Optional[Callable] = None):
    """Data-parallel twin of ``train/loop.py``'s ``train_offpolicy``, run
    by every rank: the rank steps its ``num_envs / size`` envs, writes its
    own replay, and its learner's gradients are all-reduced over the mesh
    (the algo's config must carry ``axis_name=axis``, asserted). The
    learn cadence and ``start_steps`` count GLOBAL env steps; the explore
    context's episode count is the rank's own. Returns ``(algo_state,
    merged episode returns, info)``; the record merges every rank's by
    completion step, the same on every rank."""
    from freerl_tpu_torch.train.loop import (LoopCarry, example_transition,
                                             vector_step)

    axis = _mesh_axis(mesh, axis)
    _check_axis(algo, axis, "learn_step all-reduces gradients")
    num_envs = cfg.num_envs
    epd = _envs_per_rank(num_envs, mesh)
    dev = mesh.device
    record_cap = min(cfg.max_episodes,
                     cfg.max_env_steps + cfg.chunk_size * num_envs) + epd + 1

    algo_state, _ = _start_state(algo, cfg.seed, mesh)
    generator = rank_generator(cfg.seed, mesh)
    env_state, obs = vec_reset(env, generator, epd)
    c = LoopCarry(
        algo_state=algo_state,
        buffer=algo.make_buffer(example_transition(env, algo), num_envs=epd),
        env_state=env_state, obs=obs,
        ep_return=torch.zeros(epd, device=dev),
        done_prev=torch.zeros(epd, dtype=torch.bool, device=dev),
        ep_counter=torch.zeros((), dtype=torch.int64, device=dev),
        episode_returns=torch.zeros(record_cap + 1, device=dev),
        episode_steps=torch.zeros(record_cap + 1, dtype=torch.int64,
                                  device=dev),
    )

    def step():
        vector_step(env, algo, cfg, c, generator, record_cap,
                    local_envs=epd)

    return _run_chunks(cfg, c, mesh, step, on_chunk, record_cap,
                       cfg.checkpoint_every_chunks)



def _run_chunks(cfg, c, mesh: Mesh, step: Callable, on_chunk, record_cap,
                checkpoint_every: int):
    """The chunked host loop of the two off-policy drivers: ``step()``
    ``chunk_size`` times per chunk, the lazy episode sync (an all-reduce
    at the same chunk on every rank), ``on_chunk``, checkpoints, the
    stopping rule; then the merged record and the info."""
    num_envs = cfg.num_envs
    t0 = time.time()
    chunk_i = 0
    n_eps = 0
    while True:
        for _ in range(cfg.chunk_size):
            step()
        chunk_i += 1
        n_steps = c.total_steps * num_envs
        if (chunk_i % cfg.host_sync_every == 0
                or n_steps >= cfg.max_env_steps):
            n_eps = _sync_episodes(c, mesh)
        if on_chunk is not None and chunk_i % cfg.log_every_chunks == 0:
            on_chunk(chunk_i, n_eps, n_steps, c)
        if (cfg.checkpoint_dir and checkpoint_every
                and chunk_i % checkpoint_every == 0):
            save_checkpoint_sharded(f"{cfg.checkpoint_dir}/ckpt",
                                    c.algo_state, mesh)
        if n_eps >= cfg.max_episodes or n_steps >= cfg.max_env_steps:
            break
    elapsed = time.time() - t0

    returns, counts = merged_returns(c, mesh, record_cap, cfg.max_episodes)
    n_steps = c.total_steps * num_envs
    info = {
        "elapsed_s": elapsed,
        "env_steps": n_steps,
        "updates": c.update_count,
        "env_steps_per_s": n_steps / max(elapsed, 1e-9),
        "episodes": int(counts.sum()),
        "n_devices": mesh.size,
    }
    return c.algo_state, returns, info


def train_marl_sharded(env: Env, algo, cfg, mesh: Mesh,
                       axis: Optional[str] = None,
                       on_chunk: Optional[Callable] = None):
    """Data-parallel twin of ``train/marl.py``'s ``train_marl``: the layout
    of :func:`train_offpolicy_sharded` with the multi-agent carry (obs
    ``(N, A, O)``, rewards ``(N, A)``, an ``(E, A)`` record); every
    agent's actor and critic gradients are all-reduced inside the algo's
    update."""
    from freerl_tpu_torch.train.marl import start, vector_step

    axis = _mesh_axis(mesh, axis)
    _check_axis(algo, axis, "per-agent updates all-reduce gradients")
    num_envs = cfg.num_envs
    epd = _envs_per_rank(num_envs, mesh)
    record_cap = min(cfg.max_episodes,
                     cfg.max_env_steps + cfg.chunk_size * num_envs) + epd + 1

    algo_state, _ = _start_state(algo, cfg.seed, mesh)
    generator = rank_generator(cfg.seed, mesh)
    c = start(env, algo, epd, generator, record_cap, algo_state=algo_state)
    c.episode_steps = torch.zeros(record_cap + 1, dtype=torch.int64,
                                  device=mesh.device)

    def step():
        vector_step(env, algo, cfg, c, generator, record_cap,
                    local_envs=epd)

    return _run_chunks(cfg, c, mesh, step, on_chunk, record_cap,
                       cfg.checkpoint_every)


def train_onpolicy_sharded(env: Env, algo, cfg, mesh: Mesh,
                           axis: Optional[str] = None,
                           on_iter: Optional[Callable] = None):
    """Data-parallel twin of ``train/onpolicy.py``'s ``train_onpolicy``:
    each rank rolls its ``num_envs / size`` envs for ``T = horizon //
    num_envs`` steps, then runs the K-epoch update with all-reduced
    gradients (an effective minibatch of ``minibatch_size * size``). The
    normalizers fold global-batch moments (``core/normalization.py``), so
    their stats stay replicated. The update's draws come from a generator
    seeded alike on every rank, and its ``episodes`` is the global count;
    recurrent algos (``init_policy_carry``) are refused, as in the JAX
    package."""
    from freerl_tpu_torch.train.onpolicy import learn, start, vector_step

    axis = _mesh_axis(mesh, axis)
    _check_axis(algo, axis, "update all-reduces gradients and normalizer "
                "stats")
    assert not hasattr(algo, "init_policy_carry"), (
        "recurrent on-policy algos are not supported by the sharded driver")
    num_envs = cfg.num_envs
    epd = _envs_per_rank(num_envs, mesh)
    T = max(cfg.horizon // num_envs, 1)
    record_cap = min(cfg.max_episodes,
                     cfg.max_env_steps + T * num_envs) + epd + 1

    algo_state, shared = _start_state(algo, cfg.seed, mesh)
    generator = rank_generator(cfg.seed, mesh)
    c = start(env, algo, epd, generator, record_cap, algo_state=algo_state)
    c.episode_steps = torch.zeros(record_cap + 1, dtype=torch.int64,
                                  device=mesh.device)

    t0 = time.time()
    it = 0
    n_eps = 0
    log_every = cfg.log_every_iters
    while True:
        for t in range(T):
            vector_step(env, algo, c, generator, record_cap, t, T)
        metrics = learn(algo, c, shared,
                        episodes=psum(c.ep_counter, axis))
        it += 1
        n_steps = it * T * num_envs
        if it % cfg.host_sync_every == 0 or n_steps >= cfg.max_env_steps:
            n_eps = _sync_episodes(c, mesh)
        if on_iter is not None and it % log_every == 0:
            on_iter(it, n_eps, n_steps, c, metrics)
        if cfg.checkpoint_dir and cfg.checkpoint_every \
                and it % cfg.checkpoint_every == 0:
            save_checkpoint_sharded(f"{cfg.checkpoint_dir}/ckpt",
                                    c.algo_state, mesh)
        if n_eps >= cfg.max_episodes or n_steps >= cfg.max_env_steps:
            break
    elapsed = time.time() - t0

    returns, counts = merged_returns(c, mesh, record_cap, cfg.max_episodes)
    n_steps = c.total_steps * num_envs
    info = {
        "elapsed_s": elapsed,
        "env_steps": n_steps,
        "iterations": it,
        "env_steps_per_s": n_steps / max(elapsed, 1e-9),
        "episodes": int(counts.sum()),
        "n_devices": mesh.size,
    }
    return c.algo_state, returns, info


# ---------------------------------------------------------------------------
# one data-parallel step (step-level checks)
# ---------------------------------------------------------------------------
def dp_env_learner_step(env: Env, algo, mesh: Mesh, envs_per_device: int,
                        axis: Optional[str] = None):
    """A single data-parallel training step, run by every rank.

    Returns ``(init_fn, step_fn)``:
      - ``init_fn(seed) -> carry``: the algo state (built from ``seed``,
        broadcast from rank 0), this rank's env batch and replay, and its
        generator;
      - ``step_fn(carry) -> (carry, metrics)``: one vector env step, a
        replay add, one learner step with all-reduced gradients; the
        float metrics and the step's mean reward are averaged over the
        ranks, so every rank reports the same.
    """
    from freerl_tpu_torch.algos.base import ExploreCtx
    from freerl_tpu_torch.core.types import Transition
    from freerl_tpu_torch.envs.base import vec_step_auto_reset
    from freerl_tpu_torch.train.loop import example_transition

    axis = _mesh_axis(mesh, axis)

    def init_fn(seed: int) -> dict:
        algo_state, _ = _start_state(algo, seed, mesh)
        generator = rank_generator(seed, mesh)
        env_state, obs = vec_reset(env, generator, envs_per_device)
        buffer = algo.make_buffer(example_transition(env, algo),
                                  num_envs=envs_per_device)
        return dict(algo_state=algo_state, env_state=env_state, obs=obs,
                    buffer=buffer, generator=generator, step=0)

    def step_fn(carry: dict):
        g = carry["generator"]
        ctx = ExploreCtx(
            total_env_steps=1_000_000_000,        # past every warm-up
            episodes=torch.zeros((), dtype=torch.int64, device=mesh.device),
            done_prev=torch.zeros(envs_per_device, dtype=torch.bool,
                                  device=mesh.device),
            random_steps=0,
        )
        algo_state, action = algo.explore(carry["algo_state"], carry["obs"],
                                          g, ctx)
        out = vec_step_auto_reset(env, carry["env_state"], action, g,
                                  envs_per_device)
        buffer = carry["buffer"].add(Transition(
            obs=carry["obs"], action=action, reward=out.reward,
            next_obs=out.next_obs, done=out.terminated,
            episode_done=out.episode_done))
        algo_state, buffer, metrics = algo.learn_step(
            algo_state, buffer, g, envs_per_device)
        metrics = {k: pmean(v, axis) for k, v in metrics.items()
                   if isinstance(v, torch.Tensor) and v.is_floating_point()}
        metrics["mean_reward"] = pmean(torch.mean(out.reward), axis)
        carry = dict(carry, algo_state=algo_state, env_state=out.state,
                     obs=out.carry_obs, buffer=buffer,
                     step=carry["step"] + 1)
        return carry, metrics

    return init_fn, step_fn
