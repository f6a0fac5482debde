from freerl_tpu_torch.buffers.episode import EpisodeBuffer
from freerl_tpu_torch.buffers.nstep import NStepAccumulator
from freerl_tpu_torch.buffers.per import PERBuffer
from freerl_tpu_torch.buffers.uniform import ReplayBuffer

__all__ = ["EpisodeBuffer", "NStepAccumulator", "PERBuffer", "ReplayBuffer"]
