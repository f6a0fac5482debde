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

The multi-agent family (``marl_state_from_flax``) adds two nets built from
plain flax ``nn.Dense`` (``{kernel, bias}`` with no ``Dense_0`` level):
``ATTCritic`` (``fc_obs_j``, ``fc_act_j``, ``fc_enc``, ``head_k``,
``fc_dec``, ``fc_q``) and ``MAACCritics`` (``attn/{query, key}`` with no
bias, ``attn/{value, fc_out}``, and per agent the framework ``Dense``
layers ``enc_s_i``, ``enc_sa_i``, ``fc1_i``, ``fc2_i``). A flax name
``stem_i`` is the port's ``stem.i`` (an ``nn.ModuleList``).

Kernels are ``(in, out)`` and torch weights ``(out, in)``, so they are
transposed. Adam moments start at zero on both sides and need no carrying
over.
"""
from __future__ import annotations

import re

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


def _dense(layer: dict, name: str, wrapped: bool = False,
           bias: bool = True) -> dict[str, torch.Tensor]:
    """One dense layer as ``name.weight`` (and ``name.bias``) entries: a
    plain flax ``nn.Dense``, or a framework ``Dense`` (``wrapped``)."""
    if wrapped:
        if set(layer) != {"Dense_0"}:
            raise ValueError(f"{name}: not a Dense tree: {sorted(layer)}")
        layer = layer["Dense_0"]
    if set(layer) != ({"kernel", "bias"} if bias else {"kernel"}):
        raise ValueError(f"{name}: not a dense layer: {sorted(layer)}")
    state = {f"{name}.weight": _t(layer["kernel"], transpose=True)}
    if bias:
        state[f"{name}.bias"] = _t(layer["bias"])
    return state


def _torch_name(name: str) -> str:
    """flax ``head_3`` -> torch ``head.3``; other names as they are."""
    return re.sub(r"_(\d+)$", r".\1", name)


def _count(params: dict, stem: str) -> int:
    return sum(1 for k in params if re.fullmatch(rf"{stem}_\d+", k))


def att_critic_params_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """A flax ``ATTCritic`` tree as a state_dict of the port's."""
    a, h = _count(params, "fc_obs"), _count(params, "head")
    names = ([f"fc_obs_{j}" for j in range(a)]
             + [f"fc_act_{j}" for j in range(a)] + ["fc_enc"]
             + [f"head_{k}" for k in range(h)] + ["fc_dec", "fc_q"])
    if sorted(names) != sorted(params):
        raise ValueError(f"not an ATTCritic tree: {sorted(params)}")
    state = {}
    for name in names:
        state.update(_dense(params[name], _torch_name(name)))
    return state


def maac_critics_params_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """A flax ``MAACCritics`` tree as a state_dict of the port's."""
    a = _count(params, "enc_s")
    names = [f"{stem}_{i}" for stem in ("enc_s", "enc_sa", "fc1", "fc2")
             for i in range(a)]
    attn = params.get("attn", {})
    if (sorted(names + ["attn"]) != sorted(params)
            or sorted(attn) != ["fc_out", "key", "query", "value"]):
        raise ValueError(f"not a MAACCritics tree: {sorted(params)}")
    state = {}
    for name in ("query", "key", "value", "fc_out"):
        state.update(_dense(attn[name], f"attn.{name}",
                            bias=name in ("value", "fc_out")))
    for name in names:
        state.update(_dense(params[name], _torch_name(name), wrapped=True))
    return state


def _load_net(net: torch.nn.Module, params: dict) -> None:
    if "fc_enc" in params:
        state = att_critic_params_from_flax(params)
    elif "attn" in params:
        state = maac_critics_params_from_flax(params)
    else:
        state = net_params_from_flax(params)
    net.load_state_dict(state)


# (JAX state field, port state field): the nets of MADDPG / MATD3, MASAC
# and MAAC
_MARL_NETS = (("actor_params", "actors"), ("actor_targets", "actor_targets"),
              ("critic_params", "critics"),
              ("critic_targets", "critic_targets"),
              ("critic_params", "critic"), ("critic_target", "critic_target"))


def marl_state_from_flax(state, flax_state) -> None:
    """Load a JAX MADDPG, MASAC or MAAC learner state (its param trees as
    numpy arrays) into the port's learner state of the same algorithm, in
    place: the per-agent actors and critics and their targets, MAAC's one
    critic module and its target, MASAC's ``log_alphas``."""
    loaded = 0
    for flax_field, field in _MARL_NETS:
        if not hasattr(state, field):
            continue
        nets, trees = getattr(state, field), getattr(flax_state, flax_field)
        if not isinstance(nets, list):
            nets, trees = [nets], [trees]
        if len(nets) != len(trees):
            raise ValueError(f"{field}: {len(nets)} nets, {len(trees)} trees")
        for net, tree in zip(nets, trees):
            _load_net(net, tree)
        loaded += 1
    if hasattr(state, "log_alphas"):
        values = np.asarray(flax_state.log_alphas, np.float32)
        if values.shape != (len(state.log_alphas),):
            raise ValueError(f"log_alphas: {values.shape}")
        with torch.no_grad():
            for la, v in zip(state.log_alphas, values):
                la.fill_(float(v))
    if loaded == 0:
        raise ValueError(f"not a multi-agent learner state: {type(state)}")
