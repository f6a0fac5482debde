"""Carry parameters over from the JAX package's flax params.

``net_params_from_flax`` serves the actor and critic nets of DDPG, TD3,
SAC, PPO and REINFORCE: ``TanhActor``, ``SoftmaxActor``, ``QCritic``,
``GaussianActor``, ``SoftmaxPolicy``, ``GaussianPolicy``,
``CategoricalPolicy`` and ``VCritic`` are ``Dense_k/Dense_0/{kernel, bias}``
(the hidden layers, then the head; ``GaussianActor`` and
``GaussianPolicy`` also have ``log_std``); PPO's ``BetaPolicy``
(``beta=True``) has two heads after the hidden layers, ``Dense_k`` for
alpha and ``Dense_{k+1}`` for beta; ``TwinQCritic`` and ``TwinQTable`` are
``q1_0 ... q1_out`` and ``q2_0 ... q2_out``, each
``/Dense_0/{kernel, bias}``.

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


def _by_suffix(names):
    """flax module names (``Dense_3``, ``q1_0``) in the order of their
    integer suffix, not lexicographically."""
    return sorted(names, key=lambda k: int(k.rsplit("_", 1)[1]))


def dqn_params_from_flax(params: dict,
                         dueling: bool = False) -> dict[str, torch.Tensor]:
    """Turn a flax ``QNetwork`` param tree (nested dicts of numpy arrays)
    into a ``state_dict`` for :class:`freerl_tpu_torch.algos.dqn.QNetwork`
    with the same head combination (``dueling`` as configured; Noisy and
    C51 show in the tree itself)."""
    dense = _by_suffix(k for k in params if k.startswith("Dense_"))
    noisy = _by_suffix(k for k in params if k.startswith("NoisyDense_"))
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


def _mlp_params(layers: list, prefix: str = "",
                heads: tuple = ("head",)) -> dict[str, torch.Tensor]:
    """The flax ``Dense`` layers of one MLP, in order, as ``hidden.i`` and
    head entries (``heads``, in creation order) of a torch state_dict."""
    n_hidden = len(layers) - len(heads)
    names = [f"hidden.{i}" for i in range(n_hidden)] + list(heads)
    state = {}
    for name, layer in zip(names, layers):
        layer = layer["Dense_0"]
        state[f"{prefix}{name}.weight"] = _t(layer["kernel"], transpose=True)
        state[f"{prefix}{name}.bias"] = _t(layer["bias"])
    return state


def net_params_from_flax(params: dict,
                         beta: bool = False) -> dict[str, torch.Tensor]:
    """Turn the flax param tree of a DDPG / TD3 / SAC / PPO / REINFORCE
    actor or critic (nested dicts of numpy arrays) into a ``state_dict``
    for the port's net of the same kind; ``beta`` for PPO's two-headed
    ``BetaPolicy``, whose tree alone does not tell its heads from a hidden
    layer."""
    twin = {k for k in params if k.startswith(("q1_", "q2_"))}
    if twin:
        if twin != set(params):
            raise ValueError(f"not a twin critic tree: {sorted(params)}")
        state = {}
        for q in ("q1", "q2"):
            hidden = _by_suffix(k for k in params
                                if k.startswith(f"{q}_") and k != f"{q}_out")
            layers = [params[k] for k in hidden] + [params[f"{q}_out"]]
            state.update(_mlp_params(layers, f"{q}_net."))
        return state
    dense = _by_suffix(k for k in params if k.startswith("Dense_"))
    extra = set(params) - set(dense)
    heads = ("alpha_head", "beta_head") if beta else ("head",)
    if len(dense) < len(heads) or extra - {"log_std"} or beta and extra:
        raise ValueError(f"not an actor or critic tree: {sorted(params)}")
    state = _mlp_params([params[k] for k in dense], heads=heads)
    if extra:
        state["log_std"] = _t(params["log_std"])
    return state
