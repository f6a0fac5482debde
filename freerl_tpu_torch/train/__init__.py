from freerl_tpu_torch.train.her import HERConfig, relabel_future, train_her
from freerl_tpu_torch.train.loop import OffPolicyConfig, train_offpolicy
from freerl_tpu_torch.train.marl import MARLConfig, train_marl
from freerl_tpu_torch.train.onpolicy import OnPolicyConfig, train_onpolicy

__all__ = ["HERConfig", "MARLConfig", "OffPolicyConfig", "OnPolicyConfig",
           "relabel_future", "train_her", "train_marl", "train_offpolicy",
           "train_onpolicy"]
