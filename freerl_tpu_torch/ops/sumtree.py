"""Batched stratified sum-tree descent (PER sampling): the CUDA kernel
``csrc/sumtree_descend.cu``, its plain twin and its wrapper.

Counterpart of ``freerl_tpu/ops/sumtree_pallas.py``. The tree is a
``(2*capacity,)`` f32 tensor with the root at 1 and the children of node n
at 2n and 2n+1. For each mass u the descent walks ``depth`` levels, going
right (and subtracting the left sum) when u > left-sum, and returns
``clip(node - capacity, 0, capacity - 1)`` as int32.

``sumtree_descend`` runs the plain twin for CPU tensors and the kernel for
CUDA tensors; there is no fallback between the two. ``launches`` counts the
kernel's launches, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from freerl_tpu_torch.ops import _build

launches = 0


def sumtree_descend_ref(tree: torch.Tensor, u: torch.Tensor, depth: int,
                        capacity: int) -> torch.Tensor:
    """Plain version: a loop of ``depth`` gathers (the counterpart of
    ``sumtree_descend_xla``)."""
    node = torch.ones(u.shape, dtype=torch.int64, device=u.device)
    mass = u
    for _ in range(depth):
        left = tree[2 * node]
        go_right = mass > left
        node = 2 * node + go_right.to(torch.int64)
        mass = torch.where(go_right, mass - left, mass)
    return torch.clamp(node - capacity, 0, capacity - 1).to(torch.int32)


_launch = None   # the kernel's C entry point, resolved on first use


def _resolve():
    """Build or load the kernel once and cache its entry point with its
    argument types set."""
    global _launch
    fn = _build.load("sumtree_descend").sumtree_descend_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _launch = fn
    return fn


def sumtree_descend(tree: torch.Tensor, u: torch.Tensor, depth: int,
                    capacity: int) -> torch.Tensor:
    """Descend ``u`` (B,) through ``tree`` (2*capacity,); returns (B,) int32
    leaf indices. CPU tensors take the plain twin, CUDA tensors the kernel."""
    global launches
    if not (tree.is_cuda and u.is_cuda
            and u.get_device() == (dev := tree.get_device())):
        if tree.device.type == "cpu" and u.device.type == "cpu":
            return sumtree_descend_ref(tree, u, depth, capacity)
        raise ValueError(
            f"sumtree_descend: tree on {tree.device} and u on {u.device}; "
            "both must be on the same CUDA device (or both on the CPU)"
        )
    if tree.dtype is not torch.float32 or u.dtype is not torch.float32:
        raise TypeError(
            f"sumtree_descend: needs float32 tree and u, got {tree.dtype} "
            f"and {u.dtype}"
        )
    if tree.dim() != 1 or u.dim() != 1:
        raise ValueError("sumtree_descend: tree and u must be 1-D")
    if not (tree.is_contiguous() and u.is_contiguous()):
        raise ValueError("sumtree_descend: tree and u must be contiguous")
    if (not 0 <= depth <= 30 or capacity != 1 << depth
            or tree.numel() != 2 * capacity):
        raise ValueError(
            f"sumtree_descend: needs capacity == 2**depth (depth 0..30) and a "
            f"tree of 2*capacity nodes; got depth={depth}, "
            f"capacity={capacity}, tree of {tree.numel()}"
        )
    out = torch.empty_like(u, dtype=torch.int32)
    n = u.numel()
    if n == 0:
        return out
    launch = _launch or _resolve()
    # the current stream's raw handle, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(dev)
    rc = launch(tree.data_ptr(), u.data_ptr(), out.data_ptr(), n, depth,
                capacity, stream)
    if rc != 0:
        raise RuntimeError(f"sumtree_descend_launch failed: CUDA error {rc}")
    launches += 1
    return out
