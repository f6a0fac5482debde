"""C16's step-by-step check on the CPU: the MountainCarContinuous PPO
ObsNorm recipe (``--algo PPO --env_name MountainCarContinuous-v0
--max_episodes 500 --num_envs 8 --horizon 2048 --trick ObsNorm``) run by
the JAX package's own pieces, and the port's pieces held to it at every
vector step and every update.

    python -m tests._torch_c16_lockstep [--iterations 40] [--seed 0]
        [--out results/torch/c16_lockstep.json]

The JAX side is the recipe's seed as the JAX CLI builds it, stepped in the
order of ``freerl_tpu/train/onpolicy.py``'s ``train_onpolicy`` with its
key splits: ``split(PRNGKey(seed), 3)`` into the algo's, the env's and the
loop's keys, the reset batch through ``process_obs``, then per vector step
``split(key, 3)`` (``sample_action``, ``vec_step_auto_reset``,
``process_reward``, ``process_obs``, the episode record on raw rewards)
and per iteration ``split(key)`` for the update. Each vector step and each
update is one jitted call, where the CLI runs an iteration as one scan, so
the harness's episode returns are checked against the recipe's committed
seed curve (``results/torch/jax_head/<env>/seeds/PPO_ObsNorm_seed_<s>.npy``).

At every vector step the port is held to it, each difference relative to
the larger of the value and its quantity's scale (a value near zero is the
difference of larger terms, and keeps their rounding):

1. the normalizer: the port's ``RunningMeanStd`` takes the same raw
   observations from the reset batch on (never reset to JAX's); its mean
   (at the scale of the running std), var and count, and its normalized
   ``next_obs`` and ``carry_obs`` (at unit scale), against JAX's within
   ``RTOL``;
2. the policy: the port's ``sample_action`` on JAX's normalized
   observations, with JAX's params at the iteration's start and JAX's
   normal draws (``jax.random.normal(k_act, (n, 1))``): the env action,
   the stored action and the log-prob within ``RTOL`` (at unit scale);
3. the env: the port's step from JAX's state with JAX's action: its
   observation and reward within ``golden.START_ULPS`` float32 ulps of the
   env's bounds (the position's 1.2, the speed's 0.07, the action cost's
   0.1), and the same termination and truncation.

At every iteration, the update: both from JAX's params and Adam state at
the iteration's start (``convert.py``), on JAX's rollout, the port taking
the permutations JAX's update draws as its ``draws``. GAE's advantages
and targets within ``RTOL`` at the targets' scale; the updated params
within the update tolerance of the port's parity tests (at most one
weight in 10,000 past ``ATOL_PARAMS``, none past the lr). An iteration
that misses it is run again in float64 on both sides from the same inputs
(the same hyperparameters too): by ROADMAP's rule, agreeing to
``ATOL_F64`` the gap is float32 rounding, otherwise a fault
(``update_rule``). Beside it the yardstick of float64 rounding: the
port's float64 update moved by a one-ulp nudge of every starting param;
a float64 gap within ``TWIN_FACTOR`` times that one is float64 rounding
carried by the update's dynamics (``update``). For the update whose
float64 gap is largest the record gives both gaps after each of its
epochs (``growth``).

The harness's JAX steps are also held to the JAX driver's own run of the
recipe (``where_parted``): per iteration, how far its normalizer and
params are from the driver's, and whether the driver's returns are the
committed seed curve. The verdict is ``agree`` where no comparison shows
a fault (``verdict``; ``verdict_rule`` reads the updates by the rule
alone); the JSON gives each iteration's largest differences. This module
imports both packages, as the tests do;
``tests/test_torch_c16_lockstep.py`` runs it for one short iteration.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ENV = "MountainCarContinuous-v0"
RTOL = 1e-5
ATOL_PARAMS = 1e-5          # the port's update parity tolerance
PAST_ONE_IN = 10_000        # weights allowed past it: one in this many
ATOL_F64 = 1e-9
# an update whose float64 gap between the packages is no larger than this
# many times the port's own float64 gap under a one-ulp nudge of its params
# is float64 rounding carried by the update's dynamics
TWIN_FACTOR = 10.0
OUT = os.path.join(ROOT, "results", "torch", "c16_lockstep.json")


def recipe_argv(seed: int, num_envs: int = 8, horizon: int = 2048) -> list:
    """The C16 recipe's CLI argv (``golden``'s PPO ObsNorm row) at
    ``num_envs`` and ``horizon``."""
    from freerl_tpu_torch.train import golden

    row = golden.spec_of(ENV, "PPO_ObsNorm_3_seed")
    argv = [a.format(seed=seed) for a in row.regen]
    argv[argv.index("--num_envs") + 1] = str(num_envs)
    argv[argv.index("--horizon") + 1] = str(horizon)
    return argv


def rel_err(got, want, floor=0.0) -> float:
    """The largest ``|got - want|`` over the elements, each relative to the
    larger of ``|want|`` and ``floor``, the quantity's own scale (a value
    near zero is the difference of larger terms, whose rounding it keeps);
    0 where both are 0, inf where only the scale is."""
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    gap = np.abs(got - want)
    scale = np.maximum(np.abs(want), np.asarray(floor, np.float64))
    out = np.where(gap == 0, 0.0, gap / np.where(scale == 0, 1.0, scale))
    out = np.where((gap > 0) & (scale == 0), np.inf, out)
    return float(out.max(initial=0.0))


def rms(x) -> float:
    """The root mean square of ``x``: an array's own scale."""
    import numpy as np

    return float(np.sqrt(np.mean(np.square(np.asarray(x, np.float64)))))


def env_ulps(got, want, bounds) -> float:
    """The largest gap between two batches of observations, in float32
    ulps of the larger of the value and its feature's bound (the
    MountainCar position's 1.2 and the speed's 0.07: a velocity near zero
    is the sum of terms up to that size)."""
    import numpy as np

    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                       np.asarray(bounds, np.float32))
    gap = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return float(np.max(gap / np.spacing(scale).astype(np.float64),
                        initial=0.0))


def _flax_np(tree):
    import jax
    import numpy as np

    return jax.tree.map(lambda x: np.asarray(x), tree)


def load_jax_state(algo, state, jstate, dtype=None) -> None:
    """Load JAX's PPO params and Adam state (moments and count) into the
    port's ``state``, in place, as ``dtype`` (default float32)."""
    import numpy as np
    import torch

    from freerl_tpu_torch.convert import net_params_from_flax

    dtype = dtype or torch.float32
    for net in (state.actor, state.critic):
        net.to(dtype)
    adam = jstate.opt_state.inner_state[0]
    for name in ("actor", "critic"):
        net = getattr(state, name)
        params = _flax_np(getattr(jstate, f"{name}_params"))
        net.load_state_dict({k: v.to(dtype) for k, v in
                             net_params_from_flax(params).items()})
    state.opt.state.clear()
    count = float(np.asarray(adam.count))
    for name in ("actor", "critic"):
        net = getattr(state, name)
        mu = net_params_from_flax(_flax_np(adam.mu[name]))
        nu = net_params_from_flax(_flax_np(adam.nu[name]))
        for key, p in net.named_parameters():
            if count:
                state.opt.state[p] = {
                    "step": torch.tensor(count),
                    "exp_avg": mu[key].to(dtype).clone(),
                    "exp_avg_sq": nu[key].to(dtype).clone()}


def params_gap(state, jstate) -> tuple:
    """The port's params against JAX's: the largest abs difference, the
    number past ``ATOL_PARAMS`` and the number of weights."""
    import numpy as np

    from freerl_tpu_torch.convert import net_params_from_flax

    worst, past, total = 0.0, 0, 0
    for name in ("actor", "critic"):
        tree = _flax_np(getattr(jstate, f"{name}_params"))
        # the converter rounds to float32: convert a float64 tree's float32
        # part and its remainder apart and add them in float64
        lo = jax_tree_map(lambda x: np.asarray(x, np.float64) - np.asarray(
            x, np.float32), tree)
        hi, lo = net_params_from_flax(tree), net_params_from_flax(lo)
        got = getattr(state, name).state_dict()
        for k, h in hi.items():
            w = h.double().numpy() + lo[k].double().numpy()
            d = np.abs(got[k].double().numpy() - w)
            worst = max(worst, float(d.max()))
            past += int((d > ATOL_PARAMS).sum())
            total += d.size
    return worst, past, total


def jax_tree_map(fn, tree):
    import jax

    return jax.tree.map(fn, tree)


def _to64(tree):
    import jax
    import jax.numpy as jnp
    import numpy as np

    def cast(x):
        x = np.asarray(x)
        return jnp.asarray(x, jnp.float64) if x.dtype == np.float32 \
            else jnp.asarray(x)

    return jax.tree.map(cast, tree)


def updates_f64(jalgo, algo, jstate, jroll, k_upd, perms, episodes,
                epochs=None) -> dict:
    """Both updates in float64 from JAX's state and rollout, with the same
    hyperparameters on both sides (the lr the port rounds to float32, the
    betas and eps the JAX optimizer holds in float32), over the first
    ``epochs`` epochs (all by default): the largest abs difference of the
    updated params (``f64``), and the yardstick of float64 rounding, the
    port's update moved from its own by a one-ulp nudge of every starting
    param (``f64_twin``)."""
    import dataclasses

    import jax
    import numpy as np
    import torch

    from freerl_tpu_torch.algos.ppo import Rollout

    k = epochs or jalgo.cfg.K_epochs
    jalgo = type(jalgo)(jalgo.dim_info, dataclasses.replace(
        jalgo.cfg, actor_lr=float(np.float32(jalgo.cfg.actor_lr)),
        K_epochs=k))
    with jax.enable_x64(True):
        kk = k_upd
        for e in range(k):
            kk, k_perm = jax.random.split(kk)
            assert np.array_equal(np.asarray(jax.random.permutation(
                k_perm, perms.shape[1])), perms[e].numpy())
        js64 = _to64(jstate)
        jr64 = _to64(jroll)
        jnew, _ = jax.jit(jalgo.update)(js64, jr64, k_upd,
                                        episodes=episodes)
        jnew = jax.tree.map(np.asarray, jnew)
    roll = Rollout(**{f: torch.from_numpy(np.array(getattr(jr64, f)))
                      for f in Rollout.__dataclass_fields__})
    port = dataclasses.replace(algo.cfg, K_epochs=k)
    port = type(algo)(algo.dim_info, port, device="cpu")
    runs = []
    for nudge in (False, True):
        state = port.init(torch.Generator().manual_seed(0))
        load_jax_state(port, state, js64, torch.float64)
        hyper = js64.opt_state.hyperparams
        for group in state.opt.param_groups:
            group.update(betas=(float(hyper["b1"]), float(hyper["b2"])),
                         eps=float(hyper["eps"]))
        if nudge:
            with torch.no_grad():
                for p in group["params"]:
                    p.copy_(torch.nextafter(p, torch.full_like(p, np.inf)))
        state, _ = port.update(state, roll, perms[:k],
                               episodes=torch.tensor(int(episodes)))
        runs.append(state)
    twin = max(float((a - b).abs().max()) for a, b in zip(
        runs[0].opt.param_groups[0]["params"],
        runs[1].opt.param_groups[0]["params"]))
    return dict(f64=params_gap(runs[0], jnew)[0], f64_twin=twin)


def committed_seed(seed: int):
    """The committed JAX curve of the recipe's seed, or None."""
    import numpy as np

    from freerl_tpu_torch.train import golden

    row = next(r for r in golden.JAX_PARITY if golden.row_key(r) ==
               f"{ENV}/PPO_ObsNorm_3_seed@jax_head")
    path = golden.seed_file(golden.JAX_HEAD_ROOT, row, seed)
    return np.load(path) if os.path.isfile(path) else None


def lockstep(iterations: int = 40, seed: int = 0, num_envs: int = 8,
             horizon: int = 2048) -> dict:
    """The recipe's ``iterations`` iterations on the JAX side, the port's
    pieces held to it at every vector step and update (module doc)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from freerl_tpu import cli as jax_cli
    from freerl_tpu.algos.common import gae as jax_gae
    from freerl_tpu.algos.ppo import Rollout as JaxRollout
    from freerl_tpu.envs import vec_reset, vec_step_auto_reset
    from freerl_tpu_torch import cli
    from freerl_tpu_torch.algos.common import gae
    from freerl_tpu_torch.algos.ppo import Rollout
    from freerl_tpu_torch.core.normalization import RunningMeanStd
    from freerl_tpu_torch.envs.classic import MountainCarState
    from freerl_tpu_torch.train import golden

    torch.set_num_threads(1)
    argv = recipe_argv(seed, num_envs, horizon)
    args = cli.parser().parse_args(argv + ["--device", "cpu"])
    jenv, jalgo = jax_cli.build(args)
    env, algo = cli.build(args)
    cfg = jalgo.cfg
    assert cfg.obs_norm and not (cfg.reward_norm or cfg.reward_scaling)
    n = args.num_envs
    T = max(args.horizon // n, 1)

    key = jax.random.PRNGKey(seed)
    k_algo, k_env, key = jax.random.split(key, 3)
    jstate = jalgo.init(k_algo)
    env_state, raw = vec_reset(jenv, k_env, n)
    jstate, _, obs = jalgo.process_obs(jstate, raw, raw)

    @jax.jit
    def j_step(jstate, env_state, obs, key):
        k, k_act, k_step = jax.random.split(key, 3)
        env_a, stored_a, logp = jalgo.sample_action(jstate, obs, k_act)
        eps = jax.random.normal(k_act, env_a.shape)
        out = vec_step_auto_reset(jenv, env_state, env_a, k_step, n)
        jstate, reward = jalgo.process_reward(jstate, out.reward,
                                              out.episode_done)
        jstate, next_obs, carry_obs = jalgo.process_obs(
            jstate, out.next_obs, out.carry_obs)
        return k, jstate, out, reward, next_obs, carry_obs, dict(
            env_a=env_a, stored_a=stored_a, logp=logp, eps=eps)

    @jax.jit
    def j_update(jstate, roll, key, episodes):
        k, k_upd = jax.random.split(key)
        new, metrics = jalgo.update(jstate, roll, k_upd, episodes=episodes)
        return k, k_upd, new

    @jax.jit
    def j_gae(jstate, roll):
        return jax_gae(roll.reward, jalgo.value(jstate, roll.obs),
                       jalgo.value(jstate, roll.next_obs),
                       roll.done.astype(jnp.float32),
                       roll.adv_done.astype(jnp.float32),
                       cfg.gamma, cfg.lmbda)

    def t(x):
        return torch.from_numpy(np.array(x))

    # the port's normalizer, fed the raw observations from the reset on
    norm = RunningMeanStd.create((env.dim_info.obs_dim,), "cpu").update(
        t(raw))
    state = algo.init(torch.Generator().manual_seed(0))
    worst = dict(stats=0.0, normalized=0.0)

    def hold_stats(raw_next, raw_carry, want_next, want_carry, jstate):
        # the mean relative to the running std, the normalized
        # observations to their unit scale
        nonlocal norm
        norm = norm.update(t(raw_next)) if raw_next is not None else norm
        jr = jstate.obs_rms
        worst["stats"] = max(
            worst["stats"], rel_err(norm.mean, jr.mean, np.sqrt(jr.var)),
            rel_err(norm.var, jr.var), rel_err(norm.count, jr.count))
        for got, want in ((norm.normalize(t(raw_carry)), want_carry),
                          (None if raw_next is None else
                           norm.normalize(t(raw_next)), want_next)):
            if got is not None:
                worst["normalized"] = max(worst["normalized"],
                                          rel_err(got, want, 1.0))

    hold_stats(None, raw, None, obs, jstate)
    first = dict(worst)
    ep_return = np.zeros(n, np.float32)
    returns, rows, snaps, worst_update = [], [], [], [0.0, None, None]
    for it in range(1, iterations + 1):
        load_jax_state(algo, state, jstate)
        worst = dict(stats=0.0, normalized=0.0)
        pol = dict(env_a=0.0, stored_a=0.0, logp=0.0)
        ulps, env_flags = 0.0, 0
        steps = []
        for _ in range(T):
            carry_obs_t = obs
            key, jstate, out, reward, next_obs, obs, drew = j_step(
                jstate, env_state, obs, key)
            # the policy on JAX's normalized observation and draws
            env_a, stored_a, logp = algo.sample_action(
                state, t(carry_obs_t), t(drew["eps"]))
            # each relative to its unit scale (the action bound is 1)
            for k_, got in (("env_a", env_a), ("stored_a", stored_a),
                            ("logp", logp)):
                pol[k_] = max(pol[k_], rel_err(got, drew[k_], 1.0))
            # the env from JAX's state with JAX's action
            mc = MountainCarState(position=t(env_state.position),
                                  velocity=t(env_state.velocity),
                                  t=t(env_state.t))
            _, pobs, prew, pterm, ptrunc = env.step(mc, t(drew["env_a"]),
                                                    None)
            ulps = max(ulps, env_ulps(pobs.numpy(), out.next_obs,
                                      (-env.min_position, env.max_speed)),
                       env_ulps(prew.numpy(), out.reward, 0.1))
            env_flags += int(
                (pterm.numpy() != np.asarray(out.terminated)).sum()
                + (ptrunc.numpy() != np.asarray(out.truncated)).sum())
            hold_stats(out.next_obs, out.carry_obs, next_obs, obs, jstate)
            env_state = out.state
            # the episode record on raw rewards, in env order
            ep_return = ep_return + np.asarray(out.reward)
            done = np.asarray(out.episode_done)
            returns += [float(x) for x in ep_return[done]]
            ep_return = np.where(done, 0.0, ep_return).astype(np.float32)
            steps.append(JaxRollout(
                obs=carry_obs_t, action=drew["stored_a"],
                log_pi=drew["logp"], reward=reward, next_obs=next_obs,
                done=out.terminated, adv_done=out.episode_done))
        jroll = jax.tree.map(lambda *x: jnp.stack(x), *steps)
        episodes = jnp.int32(len(returns))
        # GAE on JAX's rollout, both critics at JAX's params
        jadv, jvt = j_gae(jstate, jroll)
        roll = Rollout(**{f: t(getattr(jroll, f))
                          for f in Rollout.__dataclass_fields__})
        with torch.no_grad():
            adv, vt = gae(roll.reward, state.critic(roll.obs),
                          state.critic(roll.next_obs), roll.done,
                          roll.adv_done, cfg.gamma, cfg.lmbda)
        jpre = jstate
        key, k_upd, jstate = j_update(jstate, jroll, key, episodes)
        perms = []
        kk = k_upd
        for _ in range(cfg.K_epochs):
            kk, k_perm = jax.random.split(kk)
            perms.append(np.asarray(jax.random.permutation(k_perm, T * n)))
        perms = torch.from_numpy(np.stack(perms).astype(np.int64))
        state, _ = algo.update(state, roll, perms,
                               episodes=torch.tensor(int(episodes)))
        gap, past, total = params_gap(state, jstate)
        snaps.append(jax.tree.map(np.asarray, (
            jstate.obs_rms, jstate.actor_params, jstate.critic_params)))
        row = dict(iteration=it, episodes=int(episodes),
                   stats_rel=worst["stats"],
                   normalized_rel=worst["normalized"], **{
                       f"{k_}_rel": v for k_, v in pol.items()},
                   env_ulps=ulps, env_flags_differ=env_flags,
                   # an advantage is a target less a value: at the
                   # targets' scale
                   gae_adv_rel=rel_err(adv, jadv, rms(jvt)),
                   gae_target_rel=rel_err(vt, jvt, rms(jvt)),
                   params_abs=gap, params_past_atol=past,
                   params_total=total)
        within = past * PAST_ONE_IN <= total and gap <= cfg.actor_lr
        row["update"] = "within"
        if not within:
            f64 = updates_f64(jalgo, algo, jpre, jroll, k_upd, perms,
                              episodes)
            row.update(params_f64_abs=f64["f64"],
                       params_f64_twin_abs=f64["f64_twin"])
            row["update_rule"] = ("float32" if f64["f64"] <= ATOL_F64
                                  else "fault")
            row["update"] = (row["update_rule"] if f64["f64"] <= ATOL_F64
                             else "float64 rounding" if f64["f64"]
                             <= TWIN_FACTOR * f64["f64_twin"] else "fault")
            if f64["f64"] > worst_update[0]:
                worst_update[:] = [f64["f64"], it, (jpre, jroll, k_upd,
                                                    perms, episodes)]
        row["steps"] = ("within" if max(
            worst["stats"], worst["normalized"], *pol.values()) <= RTOL
            and ulps <= golden.START_ULPS and env_flags == 0
            else "fault")
        row["gae"] = ("within" if max(row["gae_adv_rel"],
                                      row["gae_target_rel"]) <= RTOL
                      else "fault")
        rows.append(row)
        print(json.dumps(row), flush=True)
    growth = None
    if worst_update[1] is not None:
        # the worst update's float64 gap and yardstick after each epoch
        growth = dict(iteration=worst_update[1], epochs=[
            dict(epochs=k, **updates_f64(jalgo, algo, *worst_update[2],
                                         epochs=k))
            for k in range(1, cfg.K_epochs + 1)])
    return dict(recipe=argv, iterations=iterations, vector_steps=T,
                num_envs=n, reset=first, rows=rows, returns=returns,
                growth=growth, snapshots=snaps)


def driver_run(argv: list, iterations: int) -> dict:
    """The JAX package's own driver (``train_onpolicy``, its rollout a
    ``lax.scan``) on the recipe for ``iterations`` iterations, as the CLI
    runs it: each iteration's normalizer and params, and the returns."""
    import jax
    import numpy as np

    from freerl_tpu import cli as jax_cli
    from freerl_tpu.train.onpolicy import OnPolicyConfig, train_onpolicy
    from freerl_tpu_torch import cli

    args = cli.parser().parse_args(argv + ["--device", "cpu"])
    jenv, jalgo = jax_cli.build(args)
    T = max(args.horizon // args.num_envs, 1)
    snaps = []

    def on_iter(it, n_eps, n_steps, carry, metrics):
        st = carry.algo_state
        snaps.append(jax.tree.map(np.asarray, (
            st.obs_rms, st.actor_params, st.critic_params)))

    _, returns, _ = train_onpolicy(jenv, jalgo, OnPolicyConfig(
        seed=args.seed, num_envs=args.num_envs, max_episodes=10**9,
        horizon=args.horizon, max_env_steps=iterations * T * args.num_envs,
        log_every_iters=1), on_iter=on_iter)
    return dict(snapshots=snaps, returns=np.asarray(returns))


def where_parted(out: dict, seed: int) -> dict:
    """Where the harness's eager JAX steps part from the JAX driver's scan
    on the same recipe: per iteration, the normalizer's largest relative
    gap (its statistics fold the rollout's observations, so they follow the
    trajectory) and the params' largest abs gap; the first iteration whose
    statistics part by more than ``RTOL``; and whether the driver's
    returns are the committed seed curve's."""
    import jax
    import numpy as np

    drv = driver_run(out["recipe"], out["iterations"])
    per = []
    for it, (mine, theirs) in enumerate(zip(out["snapshots"],
                                            drv["snapshots"]), 1):
        stats = max(rel_err(getattr(mine[0], f), getattr(theirs[0], f))
                    for f in ("mean", "var", "count"))
        params = max(float(np.abs(a.astype(np.float64) - b).max())
                     for a, b in zip(jax.tree.leaves(mine[1:]),
                                     jax.tree.leaves(theirs[1:])))
        per.append(dict(iteration=it, stats_rel=stats, params_abs=params))
    first = next((p["iteration"] for p in per if p["stats_rel"] > RTOL),
                 None)
    want = committed_seed(seed)
    got = drv["returns"]
    m = 0 if want is None else min(len(got), len(want))
    return dict(per_iteration=per, stats_part_at=first,
                driver_episodes=len(got),
                driver_is_committed=None if want is None else bool(
                    np.array_equal(got[:m], want[:m])))


def curve_check(out: dict, seed: int) -> dict:
    """The harness's episode returns against the recipe's committed JAX
    seed curve: how many episodes each has, whether the shared ones are
    equal bit for bit, and from which episode they part (by more than
    1e-4) and how far."""
    import numpy as np

    want = committed_seed(seed)
    got = np.asarray(out["returns"], np.float32)
    if want is None:
        return dict(committed=None)
    m = min(len(got), len(want))
    gap = np.abs(got[:m].astype(np.float64) - want[:m])
    apart = np.flatnonzero(gap > 1e-4)
    return dict(episodes=len(got), committed_episodes=len(want),
                bit_equal=bool(np.array_equal(got[:m], want[:m])),
                max_abs=float(gap.max(initial=0.0)),
                first_apart=None if not len(apart) else int(apart[0]),
                final50=float(got[-50:].mean()) if len(got) else None,
                committed_final50=float(want[-50:].mean()))


def verdict(rows: list, key: str = "update") -> str:
    """``agree`` where every iteration's steps and GAE hold and its update
    does by ``key`` (``update``: within tolerance, or within float32 or
    float64 rounding; ``update_rule``: within tolerance, or the float64
    runs within ``ATOL_F64``), else ``fault``."""
    ok = all(r["steps"] == "within" and r["gae"] == "within"
             and r.get(key, r["update"]) in ("within", "float32",
                                             "float64 rounding")
             for r in rows)
    return "agree" if ok else "fault"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    out = lockstep(args.iterations, args.seed)
    out["curve"] = curve_check(out, args.seed)
    out["parted"] = where_parted(out, args.seed)
    out["verdict"] = verdict(out["rows"])
    out["verdict_rule"] = verdict(out["rows"], "update_rule")
    out["tolerances"] = dict(rtol=RTOL, atol_params=ATOL_PARAMS,
                             past_one_in=PAST_ONE_IN, atol_f64=ATOL_F64,
                             twin_factor=TWIN_FACTOR, env_ulps=2)
    del out["snapshots"]
    returns = out.pop("returns")
    out["episodes"] = len(returns)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("verdict", "verdict_rule",
                                          "curve", "episodes")}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
