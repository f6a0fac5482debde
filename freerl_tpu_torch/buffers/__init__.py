from freerl_tpu_torch.buffers.nstep import NStepAccumulator
from freerl_tpu_torch.buffers.per import PERBuffer
from freerl_tpu_torch.buffers.uniform import ReplayBuffer

__all__ = ["NStepAccumulator", "PERBuffer", "ReplayBuffer"]
