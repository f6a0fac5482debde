"""Environment registry (counterpart: ``freerl_tpu/envs/__init__.py``).

``make(name, device=...)`` returns a batched :class:`Env` on ``device``;
``make(name, dis_to_con=True)`` wraps a continuous-action env in the
discrete bridge (16 bins for 1-D actions, ``bins_per_dim ** N`` for N-D).
Every env of the JAX package that this port has not reached yet raises
``KeyError`` naming the ROADMAP queue item that ports it.
"""
from __future__ import annotations

from freerl_tpu_torch.envs.base import (
    DisToConWrapper,
    Env,
    FixedResetWrapper,
    StepOut,
    record_scalarize,
    step_auto_reset,
    vec_reset,
    vec_step_auto_reset,
)
from freerl_tpu_torch.envs.classic import (
    CartPole,
    MountainCar,
    MountainCarContinuous,
    Pendulum,
)
from freerl_tpu_torch.envs.lunar_lander import LunarLander
from freerl_tpu_torch.envs.tabular import FrozenLake, Taxi

_REGISTRY = {
    "LunarLander-v2": LunarLander,
    "CartPole-v1": CartPole,
    "MountainCar-v0": MountainCar,
    "MountainCarContinuous-v0": MountainCarContinuous,
    "Pendulum-v1": Pendulum,
    "FrozenLake-v1": FrozenLake,
    "Taxi-v3": Taxi,
}

# envs of the JAX package not ported yet, with the ROADMAP queue A item
# that ports them
_PENDING = {
    "LunarLanderContinuous-v2": "queue A, slice 3 (continuous off-policy)",
    "GoalPendulum-v1": "queue A, slice 3 (envs/goal.py)",
    "BipedalWalker-v3": "queue A, slice 4 (envs/bipedal.py)",
    "simple_spread_v3": "queue A, slice 5 (envs/mpe.py)",
    "simple_adversary_v3": "queue A, slice 5 (envs/mpe.py)",
    "simple_tag_v3": "queue A, slice 5 (envs/mpe.py)",
    "simple_world_comm_v3": "queue A, slice 5 (envs/mpe.py)",
    "deep-sea-treasure-v0": "queue A, slice 6 (envs/mo.py)",
    "PixelCartPole-v1": "queue A, slice 6 (envs/pixel.py)",
}


def register(name: str, cls) -> None:
    _REGISTRY[name] = cls


def make(name: str, dis_to_con: bool = False, n_bins: int = 16,
         bins_per_dim: int = 2, device="cuda", **kwargs) -> Env:
    if name not in _REGISTRY:
        where = _PENDING.get(name, "no queue: the JAX package has no such env")
        raise KeyError(
            f"Env {name!r} is not ported to freerl_tpu_torch yet ({where} in "
            f"ROADMAP.md); ported: {sorted(_REGISTRY)}"
        )
    env = _REGISTRY[name](device=device, **kwargs)
    if dis_to_con and env.dim_info.is_continue:
        env = DisToConWrapper(env, n_bins=n_bins, bins_per_dim=bins_per_dim)
    return env


__all__ = [
    "CartPole",
    "DisToConWrapper",
    "Env",
    "FixedResetWrapper",
    "FrozenLake",
    "LunarLander",
    "MountainCar",
    "MountainCarContinuous",
    "Pendulum",
    "StepOut",
    "Taxi",
    "make",
    "record_scalarize",
    "register",
    "step_auto_reset",
    "vec_reset",
    "vec_step_auto_reset",
]
