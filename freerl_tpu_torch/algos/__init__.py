from freerl_tpu_torch.algos import common
from freerl_tpu_torch.algos.base import (ExploreCtx, ExploreDraws, LearnDraws,
                                         MultiAgentAlgo, OffPolicyAlgo)
from freerl_tpu_torch.algos.cem_gd3pg import (CEMGD3PG, CEMDraws,
                                             CEMGD3PGConfig, CEMGD3PGState,
                                             train_cem_gd3pg)
from freerl_tpu_torch.algos.ddpg import (DDPG, DDPGConfig, DDPGState, QCritic,
                                         SoftmaxActor, TanhActor,
                                         gumbel_softmax)
from freerl_tpu_torch.algos.dqn import DQN, DQNConfig, DQNState, QNetwork
from freerl_tpu_torch.algos.envelope import (Envelope, EnvelopeConfig,
                                             EnvelopeDDPG, EnvelopeDDPGState,
                                             EnvelopeState, MOActor, MOCritic,
                                             MOQNet, MOReplay,
                                             random_preference)
from freerl_tpu_torch.algos.es import (GES, VES, Control, sepCEM, sepCEMA,
                                       sepCEMv2, sepCMAES, sepMCEM)
from freerl_tpu_torch.algos.gail import (GAIL, Discriminator, ExpertData,
                                         GAILConfig, GAILDraws, GAILState,
                                         collect_expert_data, gail_iteration,
                                         init_logging, train_gail)
from freerl_tpu_torch.algos.happo import (HAPPO, HAPPOConfig, HAPPODraws,
                                          HAPPOState)
from freerl_tpu_torch.algos.maac import (MAAC, MAACConfig, MAACCritics,
                                         MAACState, SharedAttention,
                                         SoftmaxActorNet)
from freerl_tpu_torch.algos.maddpg import (MADDPG, MATD3, ATTCritic,
                                           MADDPGConfig, MADDPGState)
from freerl_tpu_torch.algos.mappo import (IPPO, MAPPO, AgentActor,
                                          AgentVCritic, MAPPOConfig,
                                          MAPPOState, SharedAttnVCritics)
from freerl_tpu_torch.algos.masac import MASAC, MASACConfig, MASACState
from freerl_tpu_torch.algos.mat import MAT, MATConfig, MATState
from freerl_tpu_torch.algos.ppo import (PPO, BetaPolicy, CategoricalPolicy,
                                        GaussianPolicy, PPOConfig, PPOState,
                                        Rollout, VCritic)
from freerl_tpu_torch.algos.reinforce import (REINFORCE, REINFORCEConfig,
                                              REINFORCEState)
from freerl_tpu_torch.algos.rmappo import (RIPPO, RMAPPO, HiddenCarry,
                                           RMAPPOConfig, RMAPPOState)
from freerl_tpu_torch.algos.sac import (SAC, GaussianActor, SACConfig,
                                        SACState, SoftmaxPolicy, TwinQTable)
from freerl_tpu_torch.algos.td3 import TD3, TD3Config, TD3State, TwinQCritic

__all__ = ["ATTCritic", "AgentActor", "AgentVCritic", "BetaPolicy", "CEMDraws",
           "CEMGD3PG", "CEMGD3PGConfig", "CEMGD3PGState", "CategoricalPolicy",
           "Control", "DDPG", "DDPGConfig", "DDPGState", "DQN", "DQNConfig",
           "DQNState", "Discriminator", "Envelope", "EnvelopeConfig",
           "EnvelopeDDPG", "EnvelopeDDPGState", "EnvelopeState", "ExpertData",
           "ExploreCtx", "ExploreDraws", "GAIL", "GAILConfig", "GAILDraws",
           "GAILState", "GES", "GaussianActor", "GaussianPolicy", "HAPPO",
           "HAPPOConfig", "HAPPODraws", "HAPPOState", "HiddenCarry", "IPPO",
           "LearnDraws", "MAAC", "MAACConfig", "MAACCritics", "MAACState",
           "MADDPG", "MADDPGConfig", "MADDPGState", "MAPPO", "MAPPOConfig",
           "MAPPOState", "MASAC", "MASACConfig", "MASACState", "MAT",
           "MATConfig", "MATD3", "MATState", "MOActor", "MOCritic", "MOQNet",
           "MOReplay", "MultiAgentAlgo", "OffPolicyAlgo", "PPO", "PPOConfig",
           "PPOState", "QCritic", "QNetwork", "REINFORCE", "REINFORCEConfig",
           "REINFORCEState", "RIPPO", "RMAPPO", "RMAPPOConfig", "RMAPPOState",
           "Rollout", "SAC", "SACConfig", "SACState", "SharedAttention",
           "SharedAttnVCritics", "SoftmaxActor", "SoftmaxActorNet",
           "SoftmaxPolicy", "TD3", "TD3Config", "TD3State", "TanhActor",
           "TwinQCritic", "TwinQTable", "VCritic", "VES",
           "collect_expert_data", "common", "gail_iteration", "gumbel_softmax",
           "init_logging", "random_preference", "sepCEM", "sepCEMA",
           "sepCEMv2", "sepCMAES", "sepMCEM", "train_cem_gd3pg", "train_gail"]
