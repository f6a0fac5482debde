"""Carry parameters over from the JAX package's flax params.

flax numbers the modules of a ``QNetwork`` by kind, in creation order:

- each framework ``Dense`` is ``Dense_k/Dense_0/{kernel, bias}`` (it wraps
  an ``nn.Dense``): the hidden layers, then, without Noisy, the A head and,
  under Dueling, the V head;
- under Noisy the heads are ``NoisyDense_0`` (A, or the atom logits under
  C51) and ``NoisyDense_1`` (V), each ``{w_mu, w_sigma, b_mu, b_sigma}``.

Kernels are ``(in, out)`` and torch weights ``(out, in)``, so they are
transposed. Adam moments start at zero on both sides and need no carrying
over.
"""
from __future__ import annotations

import numpy as np
import torch


def _t(x, transpose: bool = False) -> torch.Tensor:
    x = np.asarray(x, np.float32)
    return torch.from_numpy((x.T if transpose else x).copy())


def dqn_params_from_flax(params: dict,
                         dueling: bool = False) -> dict[str, torch.Tensor]:
    """Turn a flax ``QNetwork`` param tree (nested dicts of numpy arrays)
    into a ``state_dict`` for :class:`freerl_tpu_torch.algos.dqn.QNetwork`
    with the same head combination (``dueling`` as configured; Noisy and
    C51 show in the tree itself)."""
    def ordered(prefix):
        names = [k for k in params if k.startswith(prefix)]
        return sorted(names, key=lambda k: int(k.rsplit("_", 1)[1]))

    dense, noisy = ordered("Dense_"), ordered("NoisyDense_")
    heads = ["head", "v_head"] if dueling else ["head"]
    n_hidden = len(dense) - (0 if noisy else len(heads))
    if (n_hidden < 0 or len(dense) + len(noisy) != len(params)
            or noisy and len(noisy) != len(heads)):
        raise ValueError(
            f"not a QNetwork tree with dueling={dueling}: {sorted(params)}")
    state = {}
    targets = [f"hidden.{i}" for i in range(n_hidden)] + ([] if noisy else heads)
    for name, target in zip(dense, targets):
        layer = params[name]["Dense_0"]
        state[f"{target}.weight"] = _t(layer["kernel"], transpose=True)
        state[f"{target}.bias"] = _t(layer["bias"])
    for name, target in zip(noisy, heads):
        layer = params[name]
        for key in ("w_mu", "w_sigma"):
            state[f"{target}.{key}"] = _t(layer[key], transpose=True)
        for key in ("b_mu", "b_sigma"):
            state[f"{target}.{key}"] = _t(layer[key])
    return state
