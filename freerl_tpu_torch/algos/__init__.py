from freerl_tpu_torch.algos import common
from freerl_tpu_torch.algos.base import ExploreCtx, ExploreDraws, OffPolicyAlgo
from freerl_tpu_torch.algos.ddpg import (DDPG, DDPGConfig, DDPGState, QCritic,
                                         SoftmaxActor, TanhActor,
                                         gumbel_softmax)
from freerl_tpu_torch.algos.dqn import DQN, DQNConfig, DQNState, QNetwork
from freerl_tpu_torch.algos.ppo import (PPO, BetaPolicy, CategoricalPolicy,
                                        GaussianPolicy, PPOConfig, PPOState,
                                        Rollout, VCritic)
from freerl_tpu_torch.algos.reinforce import (REINFORCE, REINFORCEConfig,
                                              REINFORCEState)
from freerl_tpu_torch.algos.sac import (SAC, GaussianActor, SACConfig,
                                        SACState, SoftmaxPolicy, TwinQTable)
from freerl_tpu_torch.algos.td3 import TD3, TD3Config, TD3State, TwinQCritic

__all__ = ["BetaPolicy", "CategoricalPolicy", "DDPG", "DDPGConfig",
           "DDPGState", "DQN", "DQNConfig", "DQNState", "ExploreCtx",
           "ExploreDraws", "GaussianActor", "GaussianPolicy", "OffPolicyAlgo",
           "PPO", "PPOConfig", "PPOState", "QCritic", "QNetwork", "REINFORCE",
           "REINFORCEConfig", "REINFORCEState", "Rollout", "SAC", "SACConfig",
           "SACState", "SoftmaxActor", "SoftmaxPolicy", "TD3", "TD3Config",
           "TD3State", "TanhActor", "TwinQCritic", "TwinQTable", "VCritic",
           "common", "gumbel_softmax"]
