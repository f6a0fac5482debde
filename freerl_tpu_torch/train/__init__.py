from freerl_tpu_torch.train.evaluate import evaluate, plot_evaluate
from freerl_tpu_torch.train.her import HERConfig, relabel_future, train_her
from freerl_tpu_torch.train.loop import OffPolicyConfig, train_offpolicy
from freerl_tpu_torch.train.marl import MARLConfig, train_marl
from freerl_tpu_torch.train.onpolicy import OnPolicyConfig, train_onpolicy
from freerl_tpu_torch.train.plotting import (aggregate_seeds, exp_smooth,
                                             plot_compare,
                                             plot_learning_curve)
from freerl_tpu_torch.train.runio import (MetricsWriter, load_checkpoint,
                                          make_dir, save_checkpoint,
                                          trick_prefix)

__all__ = ["HERConfig", "MARLConfig", "MetricsWriter", "OffPolicyConfig",
           "OnPolicyConfig", "aggregate_seeds", "evaluate", "exp_smooth",
           "load_checkpoint", "make_dir", "plot_compare",
           "plot_learning_curve", "plot_evaluate", "relabel_future",
           "save_checkpoint", "train_her", "train_marl", "train_offpolicy",
           "train_onpolicy", "trick_prefix"]
