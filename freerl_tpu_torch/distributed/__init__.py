from freerl_tpu_torch.distributed.dp import dp_env_learner_step, make_mesh

__all__ = ["make_mesh", "dp_env_learner_step"]
