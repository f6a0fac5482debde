"""Device-resident uniform replay buffer (counterpart:
``freerl_tpu/buffers/uniform.py``).

The ring is a :class:`Transition` of tensors with leading dim ``capacity``,
on the device of the example it was created from. ``add`` writes a whole
vector-env batch per step and updates the buffer in place; ``sample`` draws
indices with replacement on the device.

``pos`` and ``size`` are host ints: every add carries a known number of
rows, so the host knows both without reading the device, and
``torch.randint`` can take ``size`` as its bound with no sync.
"""
from __future__ import annotations

import dataclasses

import torch

from freerl_tpu_torch.core.types import Transition


@dataclasses.dataclass
class ReplayBuffer:
    data: Transition           # tensors with leading dim = capacity
    capacity: int
    # store float fields in bfloat16; samples are upcast back to float32
    bf16_storage: bool = False
    # creation-time add-batch contract: when > 0, EVERY add carries exactly
    # this many rows, capacity is a multiple of it and pos stays aligned, so
    # the contiguous slice write can never wrap mid-batch. 0 = mixed add
    # sizes allowed, always through the modular scatter.
    align: int = 0
    pos: int = 0               # next write index
    size: int = 0              # current fill

    @classmethod
    def create(cls, capacity: int, example: Transition,
               bf16_storage: bool = False,
               add_batch: int = 0) -> "ReplayBuffer":
        """Allocate from a single example transition (no batch dim).

        ``add_batch``: the fixed per-add row count (usually ``num_envs``).
        Capacity is rounded UP to the next multiple, never below the
        requested capacity.
        """
        if add_batch > 0 and capacity % add_batch != 0:
            capacity = ((capacity + add_batch - 1) // add_batch) * add_batch

        def alloc(x):
            dt = x.dtype
            if bf16_storage and dt == torch.float32:
                dt = torch.bfloat16
            return torch.zeros((capacity,) + tuple(x.shape), dtype=dt,
                               device=x.device)

        return cls(data=example.map(alloc), capacity=capacity,
                   bf16_storage=bf16_storage, align=add_batch)

    # ------------------------------------------------------------------
    def add(self, batch: Transition) -> "ReplayBuffer":
        """Write a batch of B transitions at the ring position, in place."""
        b = batch.obs.shape[0]
        if self.align > 0 and b != self.align:
            raise ValueError(
                f"ReplayBuffer was created with add_batch={self.align} but "
                f"this add carries {b} rows; mixed add sizes de-align the "
                f"ring position and would corrupt the contiguous write "
                f"path. Create the buffer with add_batch=0 for mixed-size "
                f"adds (scatter path)."
            )
        rows, skip = self.rows(b)
        if skip:
            batch = batch.map(lambda x: x[skip:])
        for f in dataclasses.fields(Transition):
            buf = getattr(self.data, f.name)
            buf[rows] = getattr(batch, f.name).to(buf.dtype)
        self.pos = (self.pos + b) % self.capacity
        self.size = min(self.size + b, self.capacity)
        return self

    def rows(self, b: int):
        """The ring rows an add of ``b`` transitions writes, and how many
        of its leading transitions it skips. An add larger than the ring
        would write some slots twice, and a CUDA ``index_put_`` gives no
        order: it writes only its last ``capacity`` rows, the ones a
        last-writer-wins scatter keeps."""
        if self.align > 0:
            return slice(self.pos, self.pos + b), 0
        skip = max(b - self.capacity, 0)
        start = (self.pos + skip) % self.capacity
        rows = (start + torch.arange(b - skip,
                                     device=self.data.obs.device)) \
            % self.capacity
        return rows, skip

    # ------------------------------------------------------------------
    def _upcast(self, batch: Transition) -> Transition:
        if not self.bf16_storage:
            return batch
        return batch.map(
            lambda x: x.float() if x.dtype == torch.bfloat16 else x
        )

    def sample_idx(self, generator: torch.Generator,
                   batch_size: int) -> torch.Tensor:
        """Indices drawn uniformly, with replacement, from the filled part."""
        return torch.randint(0, max(self.size, 1), (batch_size,),
                             generator=generator,
                             device=self.data.obs.device)

    def sample(self, generator: torch.Generator,
               batch_size: int) -> Transition:
        return self.gather(self.sample_idx(generator, batch_size))

    def gather(self, idx: torch.Tensor) -> Transition:
        return self._upcast(self.data.map(lambda buf: buf[idx]))

    def __len__(self):
        return self.size
