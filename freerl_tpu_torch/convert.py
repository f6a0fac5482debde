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

The multi-agent on-policy family (``mappo_state_from_flax``,
``mat_state_from_flax``, ``rmappo_state_from_flax``) is mapped name by
name: a flax ``LayerNorm`` ``{scale, bias}`` is the port's
``nets/norm.py`` ``LayerNorm``; a framework ``Dense`` is one level
deeper than a plain ``nn.Dense``; the GRU's six denses keep flax's names
(``gru.dense.ir``, ...); MAT's blocks are listed in ``_MAT_NAMES``. The
stacked MAPPO nets take each agent's tree, stacked on a leading axis.

Slice 6: a pixel net's ``ConvTrunk_0`` (``Conv_i/{kernel, bias}`` and a
plain ``nn.Dense``) is its ``conv`` (``conv_params_from_flax``; a conv
kernel ``(kh, kw, in, out)`` is the weight ``(out, in, kh, kw)``); GAIL's
discriminator is plain ``nn.Dense`` and ``LayerNorm`` layers
(``gail_disc_params_from_flax``, ``gail_state_from_flax``); CEM-GD3PG's
and ENVELOPE's nets are framework ``Dense`` MLPs
(``cem_gd3pg_state_from_flax``, ``envelope_state_from_flax``), and
``flat_from_flax`` gives a tree's ``ravel_pytree`` vector.

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
    C51 show in the tree itself; a pixel net's ``ConvTrunk_0`` is its
    ``conv``)."""
    params, state = _split_conv(params)
    dense = _by_suffix(k for k in params if k.startswith("Dense_"))
    noisy = _by_suffix(k for k in params if k.startswith("NoisyDense_"))
    heads = ["head", "v_head"] if dueling else ["head"]
    n_hidden = len(dense) - (0 if noisy else len(heads))
    if (n_hidden < 0 or len(dense) + len(noisy) != len(params)
            or noisy and len(noisy) != len(heads)):
        raise ValueError(
            f"not a QNetwork tree with dueling={dueling}: {sorted(params)}")
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
    layer. A pixel net's ``ConvTrunk_0`` is its ``conv``."""
    params, conv = _split_conv(params)
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
    return {**conv, **state}


def conv_params_from_flax(params: dict,
                          prefix: str = "") -> dict[str, torch.Tensor]:
    """A flax ``ConvTrunk`` tree (``Conv_i/{kernel, bias}``, then a plain
    ``nn.Dense`` ``Dense_0``) as a state_dict of the port's: a kernel
    ``(kh, kw, in, out)`` is the weight ``(out, in, kh, kw)``."""
    convs = _by_suffix(k for k in params if k.startswith("Conv_"))
    if sorted(convs + ["Dense_0"]) != sorted(params):
        raise ValueError(f"not a ConvTrunk tree: {sorted(params)}")
    state = {}
    for i, name in enumerate(convs):
        kernel = np.asarray(params[name]["kernel"], np.float32)
        state[f"{prefix}convs.{i}"] = torch.from_numpy(
            kernel.transpose(3, 2, 0, 1).copy())
        state[f"{prefix}biases.{i}"] = _t(params[name]["bias"])
    state.update(_dense(params["Dense_0"], f"{prefix}dense"))
    return state


def _split_conv(params: dict):
    """A net's tree without its ``ConvTrunk_0``, and that trunk's
    state_dict entries under ``conv.`` (none without one)."""
    if "ConvTrunk_0" not in params:
        return params, {}
    rest = {k: v for k, v in params.items() if k != "ConvTrunk_0"}
    return rest, conv_params_from_flax(params["ConvTrunk_0"], "conv.")


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


# ---------------------------------------------------------------------------
# The multi-agent on-policy family
# ---------------------------------------------------------------------------
def _tree(tree: dict, rename, prefix: str = "") -> dict[str, torch.Tensor]:
    """A flax param tree as state_dict entries: ``rename(flax_name)`` gives
    each sub-tree's port name ("" keeps the prefix: the inner ``Dense_0``
    of a framework ``Dense``) and the rename of its own entries. Leaves:
    ``kernel`` is the transposed ``weight``; ``bias``, ``scale`` and
    ``log_std`` keep their names."""
    state = {}
    for key, value in tree.items():
        if not isinstance(value, dict):
            name = "weight" if key == "kernel" else key
            state[prefix + name] = _t(value, transpose=key == "kernel")
            continue
        name, sub = rename(key)
        state.update(_tree(value, sub, f"{prefix}{name}." if name else prefix))
    return state


def _leaves(key):
    """A dense or norm layer: its leaves only (a framework ``Dense`` holds
    one ``Dense_0``, which keeps the prefix)."""
    if key == "Dense_0":
        return "", _leaves
    raise ValueError(f"unexpected sub-tree {key!r}")


def _table(names: dict):
    """A rename from a table of flax names: ``{flax: port}`` for layers,
    ``{flax: (port, table)}`` for sub-modules; a flax name ``Block_3``
    matches the table's ``Block_*`` and becomes ``port.3``."""
    def rename(key):
        entry = names.get(key)
        if entry is None:
            stem, _, k = key.rpartition("_")
            entry = names.get(stem + "_*")
            if entry is None:
                raise ValueError(f"unexpected sub-tree {key!r}")
            port, sub = entry
            return f"{port}.{k}", _table(sub)
        if isinstance(entry, tuple):
            return entry[0], _table(entry[1])
        return entry, _leaves
    return rename


def _trunk_names(n_hidden: int, norms: list, first: str, last: str = ""):
    """The rename table of an MLP trunk: ``Dense_j`` is ``layers.j``;
    LayerNorms in ``norms`` order are ``first`` (if given), ``norms.j``,
    then ``last`` (if given)."""
    names = {f"Dense_{j}": f"layers.{j}" for j in range(n_hidden)}
    ports = ([first] if first else []) + [f"norms.{j}" for j in
                                          range(len(norms) - bool(first)
                                                - bool(last))]
    ports += [last] if last else []
    names.update({f"LayerNorm_{k}": p for k, p in enumerate(ports)})
    return names


def _agent_net(params: dict, cfg, recurrent: bool = False) -> dict:
    """A flax ``AgentActor`` / ``AgentVCritic`` (MAPPO) or
    ``RecurrentActor`` / ``RecurrentVCritic`` (rMAPPO) as a state_dict."""
    trunk_key = "RecurrentTrunk_0" if recurrent else "MLPTrunk_0"
    trunk = params[trunk_key]
    n_hidden = sum(1 for k in trunk if k.startswith("Dense_"))
    norms = [k for k in trunk if k.startswith("LayerNorm_")]
    if recurrent:
        names = _trunk_names(n_hidden, norms, "",
                             "out_norm" if cfg.layer_norm else "")
        names["GRUCell_0"] = ("gru", {k: f"dense.{k}" for k in
                                      ("ir", "hr", "iz", "hz", "in", "hn")})
    else:
        names = _trunk_names(n_hidden, norms,
                             "feature_norm" if cfg.feature_norm else "")
    return _tree(params, _table({trunk_key: ("trunk", names),
                                 "Dense_0": "head"}))


def _attn_critics(params: dict) -> dict:
    """A flax ``SharedAttnVCritics`` tree as a state_dict."""
    wrapped = {"Dense_0": ""}
    return _tree(params, _table({
        "attn": ("attn", {k: k for k in ("query", "key", "value", "fc_out")}),
        "enc_*": ("enc", wrapped), "fc1_*": ("fc1", wrapped),
        "v_*": ("v", wrapped)}))


def _load(net: torch.nn.Module, states: list) -> None:
    """Load one state_dict, or a stacked net from one per agent."""
    if len(states) == 1:
        net.load_state_dict(states[0])
    else:
        net.load_state_dict({k: torch.stack([s[k] for s in states])
                             for k in states[0]})


def mappo_state_from_flax(algo, state, flax_state) -> None:
    """Load a JAX MAPPO / IPPO / HAPPO state (its param trees as numpy
    arrays) into the port's state of ``algo``, in place: per-agent or
    stacked actors and critics, or the attention critics."""
    actors = [_agent_net(p, algo.cfg) for p in flax_state.actor_params]
    if algo.cfg.attention:
        critics = [_attn_critics(flax_state.critic_params[0])]
    else:
        critics = [_agent_net(p, algo.cfg) for p in flax_state.critic_params]
    if isinstance(state.actors, list):
        for net, sd in zip(state.actors, actors):
            _load(net, [sd])
        for net, sd in zip(state.critics if isinstance(state.critics, list)
                           else [state.critics], critics):
            _load(net, [sd])
    else:
        _load(state.actors, actors)
        _load(state.critics, critics)


def rmappo_state_from_flax(algo, state, flax_state) -> None:
    """Load a JAX rMAPPO / rIPPO state into the port's, in place."""
    for nets, trees in ((state.actors, flax_state.actor_params),
                        (state.critics, flax_state.critic_params)):
        for net, tree in zip(nets, trees):
            net.load_state_dict(_agent_net(tree, algo.cfg, recurrent=True))


_MAT_ATTN = {k: k for k in ("key", "query", "value", "proj")}
_MAT_NAMES = {
    "enc": {
        "LayerNorm_0": "obs_norm", "Dense_0": "embed",
        "LayerNorm_1": "embed_norm", "Dense_1": "v_hidden",
        "LayerNorm_2": "v_norm", "Dense_2": "v_out",
        "EncodeBlock_*": ("blocks", {
            "MATAttention_0": ("attn", _MAT_ATTN), "LayerNorm_0": "norm1",
            "Dense_0": "mlp1", "Dense_1": "mlp2", "LayerNorm_1": "norm2"}),
    },
    "dec": {
        "Dense_0": "embed", "LayerNorm_0": "embed_norm",
        "Dense_1": "head_hidden", "LayerNorm_1": "head_norm",
        "Dense_2": "head_out",
        "DecodeBlock_*": ("blocks", {
            "MATAttention_0": ("attn1", _MAT_ATTN), "LayerNorm_0": "norm1",
            "MATAttention_1": ("attn2", _MAT_ATTN), "LayerNorm_1": "norm2",
            "Dense_0": "mlp1", "Dense_1": "mlp2", "LayerNorm_2": "norm3"}),
    },
}


def mat_state_from_flax(state, flax_state) -> None:
    """Load a JAX MAT state's encoder and decoder into the port's."""
    state.encoder.load_state_dict(_tree(flax_state.enc_params,
                                        _table(_MAT_NAMES["enc"])))
    state.decoder.load_state_dict(_tree(flax_state.dec_params,
                                        _table(_MAT_NAMES["dec"])))


# ---------------------------------------------------------------------------
# Slice 6: GAIL, CEM-GD3PG, ENVELOPE
# ---------------------------------------------------------------------------
def gail_disc_params_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """A flax GAIL ``Discriminator`` tree (plain ``nn.Dense`` layers
    ``Dense_i``, the last the head, and ``LayerNorm_i`` under
    ``layernorm``) as a state_dict of the port's."""
    dense = _by_suffix(k for k in params if k.startswith("Dense_"))
    norms = _by_suffix(k for k in params if k.startswith("LayerNorm_"))
    if (len(dense) + len(norms) != len(params)
            or norms and len(norms) != len(dense) - 1):
        raise ValueError(f"not a Discriminator tree: {sorted(params)}")
    names = [f"layers.{i}" for i in range(len(dense) - 1)] + ["head"]
    state = {}
    for flax_name, name in zip(dense, names):
        state.update(_dense(params[flax_name], name))
    for i, flax_name in enumerate(norms):
        state[f"norms.{i}.scale"] = _t(params[flax_name]["scale"])
        state[f"norms.{i}.bias"] = _t(params[flax_name]["bias"])
    return state


def gail_state_from_flax(state, flax_state) -> None:
    """Load a JAX GAIL state into the port's, in place: the PPO
    generator's actor and critic, and the discriminator."""
    beta = "alpha_head.weight" in state.ppo_state.actor.state_dict()
    state.ppo_state.actor.load_state_dict(net_params_from_flax(
        flax_state.ppo_state.actor_params, beta=beta))
    state.ppo_state.critic.load_state_dict(net_params_from_flax(
        flax_state.ppo_state.critic_params))
    state.disc.load_state_dict(gail_disc_params_from_flax(
        flax_state.d_params))


def flat_from_flax(params: dict) -> np.ndarray:
    """A flax param tree as one flat float32 vector in
    ``jax.flatten_util.ravel_pytree``'s order: dict keys sorted, leaves
    raveled row-major (CEM-GD3PG's ES population vectors)."""
    if not isinstance(params, dict):
        return np.asarray(params, np.float32).reshape(-1)
    return np.concatenate([flat_from_flax(params[k]) for k in sorted(params)])


def _load_into(net: torch.nn.Module, params: dict) -> None:
    net.load_state_dict(net_params_from_flax(params))


def cem_gd3pg_state_from_flax(state, flax_state) -> None:
    """Load a JAX CEM-GD3PG state (its param trees as numpy arrays) into
    the port's, in place: both actors, their targets, the domain actor,
    the critic and its target, and the float32 fitness EMAs."""
    for name in ("actor1", "actor2", "actor1_target", "actor2_target",
                 "domain", "critic", "critic_target"):
        _load_into(getattr(state, name), getattr(flax_state, name))
    state.f1_total = np.float32(flax_state.f1_total)
    state.f2_total = np.float32(flax_state.f2_total)


def envelope_state_from_flax(state, flax_state) -> None:
    """Load a JAX ENVELOPE state into the port's, in place: ``MOQNet``
    and its target (``Envelope``), or ``MOActor`` / ``MOCritic`` and their
    targets (``EnvelopeDDPG``); beta and its delta."""
    if hasattr(flax_state, "params"):
        pairs = (("net", "params"), ("target_net", "target_params"))
    else:
        pairs = (("actor", "actor_params"), ("actor_target", "actor_target"),
                 ("critic", "critic_params"), ("critic_target",
                                               "critic_target"))
    for name, flax_name in pairs:
        _load_into(getattr(state, name), getattr(flax_state, flax_name))
    with torch.no_grad():
        state.beta.fill_(float(flax_state.beta))
        state.beta_delta.fill_(float(flax_state.beta_delta))
