from freerl_tpu_torch.train.her import HERConfig, relabel_future, train_her
from freerl_tpu_torch.train.loop import OffPolicyConfig, train_offpolicy

__all__ = ["HERConfig", "OffPolicyConfig", "relabel_future", "train_her",
           "train_offpolicy"]
