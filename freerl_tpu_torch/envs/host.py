"""Host env bridge: run real Python envs inside the training drivers
(counterpart: ``freerl_tpu/envs/host.py``).

The batched torch envs are the fast path, but some envs cannot be
re-derived (SMACv2's StarCraft binary) and users may want the original
gymnasium implementations bit for bit. :class:`HostVecEnv` wraps N host
envs with gymnasium's interface behind the drivers' vectorized protocol
(``vec_reset`` / ``vec_step_auto_reset``, which ``envs/base.py`` hands off
to): the device computes actions, they go to the host once per vector step
(``.cpu().numpy()``, the bridge's one sync), all N host envs step, and the
results come back as tensors on ``env.device``.

Auto-reset happens on the host. The true ``next_obs`` is returned apart
from the post-reset ``carry_obs``, preserving the buffer semantics.
Throughput is host-bound: this is the compatibility path, not the fast
path.

Spaces are read by duck typing, so gymnasium itself is never imported: an
action space with ``.n`` is discrete, one with ``.shape`` and ``.high`` is
a box. Any env with gymnasium's ``reset(seed=) -> (obs, info)`` and
``step(a) -> (obs, r, terminated, truncated, info)`` works, gymnasium
installed or not.

``num_workers > 1`` shards the host envs over worker processes, stepping
the shards concurrently while the device trains. The workers start from a
``forkserver`` (a ``fork`` after CUDA has started would hand the child a
CUDA context it cannot use) that preloads the torch-free
``envs/_host_worker.py``. ``make_fn`` travels to them pickled: with
cloudpickle where it imports (a lambda works), else with ``pickle``, which
needs a function or class defined at module level; a ``make_fn`` that
cannot be pickled raises a ``TypeError`` that says so. Each worker
imports the main script again before it starts (multiprocessing's spawn
preparation), so a script that starts workers keeps its work under an
``if __name__ == "__main__":`` guard.

Usage:
    env = HostVecEnv(lambda: gym.make("LunarLander-v3"), num_envs=16,
                     num_workers=4, device="cuda")
    train_offpolicy(env, algo, OffPolicyConfig(num_envs=16, ...))
    env.close()
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.envs._host_worker import (_close, _reset_envs,
                                                _step_envs, _worker_main,
                                                dumps)
from freerl_tpu_torch.envs.base import Env, StepOut

SEED_HIGH = 2**31 - 1     # reset seeds are drawn from [0, SEED_HIGH)


@dataclasses.dataclass
class HostEnvState:
    """A token for the drivers; the real state lives in the host envs."""

    tick: int = 0


def draw_seed(generator: torch.Generator) -> int:
    """The reset seed, from ``generator`` over [0, 2**31 - 1)."""
    return int(torch.randint(0, SEED_HIGH, (), generator=generator,
                             device=generator.device))


def dim_info_of(obs_space, act_space) -> DimInfo:
    """DimInfo from gymnasium-style spaces, by duck typing."""
    obs_dim = int(np.prod(getattr(obs_space, "shape", None) or (1,)))
    if hasattr(act_space, "n"):
        return DimInfo(obs_dim=obs_dim, action_dim=int(act_space.n),
                       is_continue=False)
    if hasattr(act_space, "shape") and hasattr(act_space, "high"):
        return DimInfo(obs_dim=obs_dim, action_dim=int(act_space.shape[0]),
                       is_continue=True,
                       max_action=float(np.asarray(act_space.high).flat[0]))
    raise TypeError(f"unsupported action space {act_space!r}: expected a "
                    f"discrete space (.n) or a box (.shape and .high)")


class HostBridge(Env):
    """The drivers' vectorized protocol (reached through ``envs/base.py``)
    over envs stepped on the host: a subclass provides
    ``_host_reset(seed) -> obs`` and ``_host_step(actions) -> (next_obs,
    carry_obs, reward, terminated, truncated)`` on numpy arrays, and sets
    ``num_envs``. Its seeds come from a ``torch.Generator``, as the JAX
    bridge's come from its host seeding outside ``jax.random``: it has no
    JAX key draws (``host_seeded``)."""

    num_envs: int
    host_seeded = True

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    # ------------------------------------------------------------------
    # the vectorized protocol the drivers reach through envs/base.py
    def vec_reset(self, generator: torch.Generator, num_envs: int):
        if num_envs != self.num_envs:
            raise ValueError(f"{type(self).__name__} is fixed-size; "
                             f"construct it with the loop's num_envs")
        obs = self._host_reset(draw_seed(generator))
        return HostEnvState(), self._tensor(obs)

    def vec_step_auto_reset(self, state: HostEnvState, action: torch.Tensor,
                            generator: torch.Generator,
                            num_envs: int) -> StepOut:
        next_obs, carry_obs, reward, term, trunc = self._host_step(
            action.detach().cpu().numpy())
        return StepOut(
            state=HostEnvState(tick=state.tick + 1),
            carry_obs=self._tensor(carry_obs),
            next_obs=self._tensor(next_obs),
            reward=self._tensor(reward),
            terminated=self._tensor(term),
            truncated=self._tensor(trunc),
        )


class HostVecEnv(HostBridge):
    """N host envs stepped in lockstep, auto-reset on the host."""

    def __init__(self, make_fn: Callable, num_envs: int,
                 max_steps: int | None = None, num_workers: int = 0,
                 device="cuda"):
        super().__init__(device)
        self.make_fn = make_fn
        self.num_envs = num_envs
        self.num_workers = num_workers if num_workers > 1 else 0
        self._pipes = None       # workers start lazily, at the first reset
        if self.num_workers:
            if num_envs % self.num_workers:
                raise ValueError("num_envs must divide evenly over "
                                 "num_workers")
            self._payload = dumps(make_fn)
            probe = make_fn()
            self._envs = []
        else:
            self._envs = [make_fn() for _ in range(num_envs)]
            probe = self._envs[0]
        self.dim_info = dim_info_of(probe.observation_space,
                                    probe.action_space)
        spec = getattr(probe, "spec", None)
        self.max_steps = max_steps or (
            getattr(spec, "max_episode_steps", None) or 1000)
        self.reward_threshold = getattr(spec, "reward_threshold", None)
        self.name = getattr(spec, "id", "HostVecEnv")
        if self.num_workers:
            _close(probe)

    # ------------------------------------------------------------------
    def _ensure_workers(self):
        if self._pipes is not None:
            return
        import multiprocessing as mp

        ctx = mp.get_context("forkserver")
        # override the default ['__main__'] preload: an entry script
        # without a main guard (pytest's console script) would otherwise
        # run inside the forkserver
        ctx.set_forkserver_preload(["freerl_tpu_torch.envs._host_worker"])
        n_local = self.num_envs // self.num_workers
        self._pipes, self._procs = [], []
        for _ in range(self.num_workers):
            parent, child = ctx.Pipe()
            p = ctx.Process(
                target=_worker_main,
                args=(child, self._payload, n_local,
                      self.dim_info.is_continue),
                daemon=True,
            )
            p.start()
            child.close()
            self._pipes.append(parent)
            self._procs.append(p)

    def close(self):
        """Stop the worker processes (and close the local envs)."""
        if self._pipes is not None:
            for pipe in self._pipes:
                try:
                    pipe.send(("close", None))
                    pipe.close()
                except (BrokenPipeError, OSError):
                    pass
            for p in self._procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5)
            self._pipes = None
        for e in self._envs:
            _close(e)

    # ------------------------------------------------------------------
    def _host_reset(self, seed: int) -> np.ndarray:
        """Reset env i with seed ``seed + i``: (num_envs, obs_dim) obs."""
        if self.num_workers:
            self._ensure_workers()
            n_local = self.num_envs // self.num_workers
            for w, pipe in enumerate(self._pipes):
                pipe.send(("reset", int(seed) + w * n_local))
            return np.concatenate([pipe.recv() for pipe in self._pipes])
        return _reset_envs(self._envs, seed)

    def _host_step(self, actions: np.ndarray):
        """Step every env once: (next_obs, carry_obs, reward, terminated,
        truncated) as numpy arrays."""
        actions = np.asarray(actions)
        if self.num_workers:
            # scatter the shards, then gather: they step concurrently
            for pipe, shard in zip(self._pipes,
                                   np.split(actions, self.num_workers)):
                pipe.send(("step", shard))
            outs = [pipe.recv() for pipe in self._pipes]
            return tuple(np.concatenate([o[i] for o in outs])
                         for i in range(5))
        return _step_envs(self._envs, actions, self.dim_info.is_continue)
