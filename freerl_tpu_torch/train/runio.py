"""Run directories, metric logging and full-train-state checkpoints
(counterpart: ``freerl_tpu/train/runio.py``).

- ``make_dir``: auto-numbered ``results/<env>/<Policy_(tricks)_N>`` run
  dirs with the reference's trick-name prefix convention;
- ``MetricsWriter``: TensorBoard per-episode reward scalars (through
  ``torch.utils.tensorboard`` where tensorboard is installed; no writer
  otherwise) and the ``<Policy>_seed_<s>.npy`` curve;
- ``save_checkpoint`` / ``load_checkpoint``: the FULL algo state (nets,
  targets, optimizer moments and param groups, normalizer stats, host
  counters), so training resumes bit-exact. Replay, env state and the
  generator are not saved, as in the JAX package.

A checkpoint is a plain tree written with ``torch.save`` and read with
``torch.load(weights_only=True)``. The tree is built by walking the state:
a dataclass becomes a dict of its fields, an ``nn.Module`` or an optimizer
its ``state_dict()``, a tensor itself, lists, tuples and dicts their
walked items, and int, float, bool, str and None themselves. Any other
type raises a ``TypeError`` that names the field: nothing is skipped
silently. Loading writes into an example state IN PLACE
(``load_state_dict`` for modules and optimizers, ``copy_`` for tensors,
``setattr`` for host fields), because each optimizer holds references to
its module's parameters: a module rebuilt from the file would leave the
optimizer stepping the old ones.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

import numpy as np
import torch
from torch import nn

_HOST = (bool, int, float, str, type(None))


def trick_prefix(policy_name: str, trick: Optional[dict] = None) -> str:
    """Reference naming: ``Policy_`` or ``Policy_TrickA_TrickB_``."""
    if not trick or not any(trick.values()):
        return policy_name + "_"
    prefix = policy_name + "_"
    for key, val in trick.items():
        if val:
            prefix += f"{key}_"
    return prefix


def make_dir(results_root: str, env_name: str, policy_name: str = "DQN",
             trick: Optional[dict] = None) -> str:
    """Auto-numbered run dir: results/<env>/<prefix><n+1>."""
    env_dir = os.path.join(results_root, env_name)
    os.makedirs(env_dir, exist_ok=True)
    prefix = trick_prefix(policy_name, trick)
    pattern = re.compile(rf"^{re.escape(prefix)}\d+$")
    existing = [d for d in os.listdir(env_dir) if pattern.match(d)]
    nums = [int(d.rsplit("_", 1)[-1]) for d in existing]
    n = max(nums, default=0) + 1
    while True:
        model_dir = os.path.join(env_dir, f"{prefix}{n}")
        try:
            os.makedirs(model_dir)
            return model_dir
        except FileExistsError:
            # a run started beside this one took the number first
            n += 1


class MetricsWriter:
    """TensorBoard scalars and the chronological .npy curve.

    Mirrors the reference's SummaryWriter('reward', ep) / per-agent
    'reward_<id>' logging and its ``<Policy>_seed_<s>.npy`` curve.
    """

    def __init__(self, model_dir: str, policy_name: str, seed: int,
                 use_tensorboard: bool = True, agent_names=None):
        self.model_dir = model_dir
        self.policy_name = policy_name
        self.seed = seed
        self.agent_names = agent_names
        self.writer = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:      # tensorboard is not installed
                SummaryWriter = None
            if SummaryWriter is not None:
                self.writer = SummaryWriter(model_dir)

    def log_episodes(self, returns: np.ndarray, start_episode: int = 0):
        if self.writer is None:
            return
        for i, r in enumerate(np.asarray(returns)):
            ep = start_episode + i + 1
            if np.ndim(r) == 0:
                self.writer.add_scalar("reward", float(r), ep)
            else:
                names = self.agent_names or [
                    f"agent_{j}" for j in range(len(r))]
                for name, rj in zip(names, r):
                    self.writer.add_scalar(f"reward_{name}", float(rj), ep)

    def log_scalar(self, tag: str, value: float, step: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), step)

    def save_curve(self, returns: np.ndarray):
        path = os.path.join(self.model_dir,
                            f"{self.policy_name}_seed_{self.seed}.npy")
        np.save(path, np.asarray(returns))
        return path

    def close(self):
        if self.writer is not None:
            self.writer.close()


# ---------------------------------------------------------------------------
def state_tree(x, name: str = "state"):
    """The plain tree a checkpoint holds for ``x`` (see the module
    docstring); ``name`` is the field's path, for the error."""
    if isinstance(x, (nn.Module, torch.optim.Optimizer)):
        return x.state_dict()
    if isinstance(x, torch.Tensor):
        return x.detach()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: state_tree(getattr(x, f.name), f"{name}.{f.name}")
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return type(x)(state_tree(v, f"{name}[{i}]")
                       for i, v in enumerate(x))
    if isinstance(x, dict):
        return {k: state_tree(v, f"{name}[{k!r}]") for k, v in x.items()}
    if isinstance(x, _HOST) and not isinstance(x, np.generic):
        return x
    raise TypeError(f"save_checkpoint: {name} is a {type(x).__name__}, "
                    f"which a checkpoint does not hold (supported: "
                    f"dataclass, nn.Module, optimizer, tensor, list, "
                    f"tuple, dict, int, float, bool, str, None)")


def save_checkpoint(path: str, train_state) -> str:
    """Write the full train state to ``path`` (one file, replaced
    atomically); returns the absolute path."""
    path = os.path.abspath(path)
    tree = state_tree(train_state, "state")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    return path


def _device_of(x) -> Optional[torch.device]:
    """The device of the first tensor in ``x``; None if it holds none."""
    if isinstance(x, nn.Module):
        x = [*x.parameters(), *x.buffers()]
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, torch.Tensor):
        return x.device
    if isinstance(x, (list, tuple)):
        for v in x:
            dev = _device_of(v)
            if dev is not None:
                return dev
    return None


@torch.no_grad()
def _restore(example, saved, name: str):
    """Write ``saved`` into ``example`` in place; returns what the
    caller's field should hold (``example`` itself, or a host value)."""
    if isinstance(example, (nn.Module, torch.optim.Optimizer)):
        example.load_state_dict(saved)
        return example
    if isinstance(example, torch.Tensor):
        if example.shape != saved.shape:
            raise ValueError(f"load_checkpoint: {name} has shape "
                             f"{tuple(saved.shape)} in the checkpoint and "
                             f"{tuple(example.shape)} in the example")
        example.copy_(saved)
        return example
    if dataclasses.is_dataclass(example) and not isinstance(example, type):
        for f in dataclasses.fields(example):
            value = _restore(getattr(example, f.name), saved[f.name],
                             f"{name}.{f.name}")
            setattr(example, f.name, value)
        return example
    if isinstance(example, list):
        _same_length(example, saved, name)
        for i, (ex, sv) in enumerate(zip(example, saved)):
            example[i] = _restore(ex, sv, f"{name}[{i}]")
        return example
    if isinstance(example, tuple):
        _same_length(example, saved, name)
        return type(example)(_restore(ex, sv, f"{name}[{i}]")
                             for i, (ex, sv) in enumerate(zip(example,
                                                              saved)))
    if isinstance(example, dict):
        for k in example:
            example[k] = _restore(example[k], saved[k], f"{name}[{k!r}]")
        return example
    state_tree(example, name)      # raises for an unsupported type
    return saved


def _same_length(example, saved, name: str) -> None:
    if len(example) != len(saved):
        raise ValueError(f"load_checkpoint: {name} has {len(saved)} items "
                         f"in the checkpoint and {len(example)} in the "
                         f"example")


def load_checkpoint(path: str, example_state):
    """Restore the checkpoint at ``path`` INTO ``example_state`` (a state
    of the same algo and config, e.g. a fresh ``algo.init``), on the
    example's device; returns ``example_state``."""
    device = _device_of(example_state) or torch.device("cpu")
    saved = torch.load(os.path.abspath(path), map_location=device,
                       weights_only=True)
    return _restore(example_state, saved, "state")
