from freerl_tpu_torch.train.her import HERConfig, relabel_future, train_her
from freerl_tpu_torch.train.loop import OffPolicyConfig, train_offpolicy
from freerl_tpu_torch.train.onpolicy import OnPolicyConfig, train_onpolicy

__all__ = ["HERConfig", "OffPolicyConfig", "OnPolicyConfig", "relabel_future",
           "train_her", "train_offpolicy", "train_onpolicy"]
