from freerl_tpu_torch.algos import common
from freerl_tpu_torch.algos.base import ExploreCtx, OffPolicyAlgo
from freerl_tpu_torch.algos.dqn import DQN, DQNConfig, DQNState, QNetwork

__all__ = ["DQN", "DQNConfig", "DQNState", "ExploreCtx", "OffPolicyAlgo",
           "QNetwork", "common"]
