"""Environment registry (counterpart: ``freerl_tpu/envs/__init__.py``).

``make(name, device=...)`` returns a batched :class:`Env` on ``device``;
``make(name, dis_to_con=True)`` wraps a continuous-action env in the
discrete bridge (16 bins for 1-D actions, ``bins_per_dim ** N`` for N-D).
Every env the JAX package's ``make`` serves is registered; another name
raises ``KeyError``.
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
from freerl_tpu_torch.envs.bipedal import BipedalWalker
from freerl_tpu_torch.envs.classic import (
    CartPole,
    MountainCar,
    MountainCarContinuous,
    Pendulum,
)
from freerl_tpu_torch.envs.goal import GoalPendulum
from freerl_tpu_torch.envs.lunar_lander import LunarLander, LunarLanderContinuous
from freerl_tpu_torch.envs.masked import ActionMaskWrapper, MaskedSpread
from freerl_tpu_torch.envs.mo import DeepSeaTreasure
from freerl_tpu_torch.envs.mpe import (
    MPEBase,
    SimpleAdversary,
    SimpleSpread,
    SimpleTag,
    SimpleWorldComm,
)
from freerl_tpu_torch.envs.pixel import PixelCartPole
from freerl_tpu_torch.envs.tabular import FrozenLake, Taxi

_REGISTRY = {
    "BipedalWalker-v3": BipedalWalker,
    "LunarLander-v2": LunarLander,
    "LunarLanderContinuous-v2": LunarLanderContinuous,
    "CartPole-v1": CartPole,
    "MountainCar-v0": MountainCar,
    "MountainCarContinuous-v0": MountainCarContinuous,
    "Pendulum-v1": Pendulum,
    "FrozenLake-v1": FrozenLake,
    "Taxi-v3": Taxi,
    "GoalPendulum-v1": GoalPendulum,
    "simple_spread_v3": SimpleSpread,
    "simple_adversary_v3": SimpleAdversary,
    "simple_tag_v3": SimpleTag,
    "simple_world_comm_v3": SimpleWorldComm,
    "deep-sea-treasure-v0": DeepSeaTreasure,
    "PixelCartPole-v1": PixelCartPole,
}


def register(name: str, cls) -> None:
    _REGISTRY[name] = cls


def make(name: str, dis_to_con: bool = False, n_bins: int = 16,
         bins_per_dim: int = 2, device="cuda", **kwargs) -> Env:
    if name not in _REGISTRY:
        raise KeyError(
            f"Unknown env {name!r}; registered: {sorted(_REGISTRY)}")
    env = _REGISTRY[name](device=device, **kwargs)
    if dis_to_con and env.dim_info.is_continue:
        env = DisToConWrapper(env, n_bins=n_bins, bins_per_dim=bins_per_dim)
    return env


__all__ = [
    "ActionMaskWrapper",
    "BipedalWalker",
    "CartPole",
    "DeepSeaTreasure",
    "DisToConWrapper",
    "Env",
    "FixedResetWrapper",
    "FrozenLake",
    "GoalPendulum",
    "LunarLander",
    "LunarLanderContinuous",
    "MPEBase",
    "MaskedSpread",
    "MountainCar",
    "MountainCarContinuous",
    "Pendulum",
    "PixelCartPole",
    "SimpleAdversary",
    "SimpleSpread",
    "SimpleTag",
    "SimpleWorldComm",
    "StepOut",
    "Taxi",
    "make",
    "record_scalarize",
    "register",
    "step_auto_reset",
    "vec_reset",
    "vec_step_auto_reset",
]
