"""C20's step-by-step check on the CPU: the GAIL script's PPO expert on
Pendulum-v1 (``scripts/gail_e2e.py:72-80``: 8 envs, horizon 400, minibatch
64, ``obs_norm``, ``reward_scaling``, ``adv_norm``, ``lr_decay`` over the
expert's 3,000 episodes, ``orthogonal_init``, ``tanh=False``, lr 3e-4) and
then one GAIL iteration of its learner (``scripts/gail_e2e.py:113-122``:
PPO at horizon 2048, lr 1e-4; one D step at d_lr 1e-4), run by the JAX
package's own pieces, with the port's pieces held to them at every vector
step and every update.

    python -m tests._torch_c20_lockstep [--iterations 8] [--seed 0]
        [--out results/torch/c20_lockstep.json]

The configs are the port script's (``scripts/torch_gail_e2e.py``'s
``expert_configs`` and ``gail_configs``, which
``tests/test_torch_gail_e2e.py`` holds field by field to what the JAX
script builds); each JAX config here is built from the port's fields and
checked against the JAX script's literal recipe (``EXPERT_RECIPE``,
``GAIL_RECIPE``).

The JAX side steps in the order and with the key splits of
``freerl_tpu/train/onpolicy.py`` (the expert, from ``PRNGKey(seed)``) and
of ``freerl_tpu/algos/gail.py``'s ``train_gail`` (the GAIL iteration,
from ``PRNGKey(seed + 1)``), one jitted call a vector step. At every
vector step the port is held to it, each difference relative to the
larger of the value and its quantity's scale (``_torch_c16_lockstep``'s
``rel_err``), in this order:

1. the starts: the reset batch and every auto-reset, the port's
   ``reset`` of ``key_reset_draw`` on the JAX step's own reset keys,
   within ``golden.START_ULPS`` float32 ulps of Pendulum's bounds;
2. the policy: ``sample_action`` on JAX's normalized observations with
   JAX's params at the iteration's start and JAX's normal draws: the env
   action, the stored action and the log-prob within ``RTOL`` (unit
   scale);
3. the env: the port's step from JAX's state with JAX's action, its
   observation and reward within ``golden.START_ULPS`` ulps of the bounds
   and the same termination and truncation;
4. (the expert) ``RewardScaling``: the port's own, fed JAX's raw rewards
   and episode ends from the start: its running return (at its rms), its
   stats and the scaled reward within ``RTOL``;
5. (the expert) ``RunningMeanStd``: the port's own, fed JAX's raw
   observations: its stats and the normalized observations, as C16's.

At every update, from JAX's params and Adam state (``load_jax_state``) on
JAX's rollout with JAX's permutations: GAE within ``RTOL`` at the
targets' scale; the lr the port sets from the same episode count
(``lr_decay``) within ``RTOL`` of JAX's; the updated params by C16's
update rule (at most one weight in 10,000 past ``ATOL_PARAMS``, none past
the lr; else the float64 rerun, ``updates_f64``). The GAIL iteration adds
the D step on JAX's expert and policy batches from JAX's D params
(``ATOL_PARAMS``, as an update) and the relabelled rewards of the updated
D (``RTOL`` at their rms). The first quantity past its tolerance, in the
order above, names the fault (``first_fault``); the verdict is C16's rule
over the updates with the D step and the relabel beside them.

Beside the checks, the harness's expert returns against the JAX side's
kept seed-0 expert curve (``results/torch/jax_head/gail/``): whether the
eager JAX steps reproduce the run that C20's statistics read. This module
imports both packages, as the tests do;
``tests/test_torch_c20_lockstep.py`` runs it for one short iteration.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tests._torch_c16_lockstep import (  # noqa: E402
    ATOL_F64, ATOL_PARAMS, PAST_ONE_IN, RTOL, TWIN_FACTOR, load_jax_state,
    params_gap, rel_err, rms, updates_f64)
from tests._torch_c16_lockstep import env_ulps  # noqa: E402
from tests._torch_c16_lockstep import verdict as c16_verdict  # noqa: E402
from freerl_tpu_torch.train.golden import START_ULPS  # noqa: E402

ENV = "Pendulum-v1"
OUT = os.path.join(ROOT, "results", "torch", "c20_lockstep.json")
# Pendulum's bounds: cos and sin 1, the speed 8; the reward's largest cost
# pi^2 + 0.1 * 8^2 + 0.001 * 2^2 = 16.27
OBS_BOUNDS = (1.0, 1.0, 8.0)
REWARD_BOUND = 16.3
# the JAX script's expert and GAIL configs, as its lines 72-80 and 113-122
# write them (the expert's critic_lr, a field its PPO never reads, aside)
EXPERT_RECIPE = dict(horizon=400, minibatch_size=64, num_envs=8,
                     adv_norm=True, actor_lr=3e-4, obs_norm=True,
                     reward_scaling=True, orthogonal_init=True, tanh=False,
                     lr_decay=True, lr_decay_episodes=3000)
GAIL_RECIPE = dict(horizon=2048, minibatch_size=64, num_envs=8,
                   actor_lr=1e-4, adv_norm=True, orthogonal_init=True,
                   tanh=False)
D_RECIPE = dict(d_steps_per_iter=1, d_lr=1e-4)
N_EXPERT = 20_000
# a vector step's quantities in the order the step computes them: the
# first past its tolerance names the fault
STEP_ORDER = ("reset_ulps", "policy_rel", "env_ulps", "env_flags",
              "scaling_ret_rel", "scaling_stats_rel", "scaled_rel",
              "norm_stats_rel", "normalized_rel")
UPDATE_ORDER = ("d_params_abs", "relabel_rel", "gae_adv_rel",
                "gae_target_rel", "lr_rel", "params_abs")


def jax_config(cls, port_cfg, recipe: dict):
    """The JAX config of the port's fields (``cls`` the JAX class), each
    recipe field checked against the JAX script's value and every field
    the two share equal."""
    jcfg = cls(**{f.name: getattr(port_cfg, f.name)
                  for f in dataclasses.fields(port_cfg)})
    for name, value in recipe.items():
        assert getattr(jcfg, name) == value, (name, getattr(jcfg, name))
    return jcfg


def configs(seed: int, expert_episodes: int, num_envs: int, expert_horizon: int,
            gail_horizon: int) -> dict:
    """The expert's and GAIL's port and JAX configs, built as the port
    script builds them, at ``num_envs`` and the two horizons."""
    from freerl_tpu.algos.gail import GAILConfig as JaxGAILConfig
    from freerl_tpu.algos.ppo import PPOConfig as JaxPPOConfig
    from scripts.torch_gail_e2e import expert_configs, gail_configs

    expert, loop = expert_configs(expert_episodes, seed)
    assert (loop.seed, loop.num_envs, loop.horizon) == (
        seed, expert.num_envs, expert.horizon)
    recipe = dict(EXPERT_RECIPE, lr_decay_episodes=expert_episodes)
    jexpert = jax_config(JaxPPOConfig, expert, recipe)
    gppo, gcfg = gail_configs()
    jgppo = jax_config(JaxPPOConfig, gppo, GAIL_RECIPE)
    jgcfg = jax_config(JaxGAILConfig, gcfg, D_RECIPE)

    def at(cfg, horizon):
        return dataclasses.replace(cfg, num_envs=num_envs, horizon=horizon)

    return dict(expert=at(expert, expert_horizon),
                jexpert=at(jexpert, expert_horizon),
                gail_ppo=at(gppo, gail_horizon),
                jgail_ppo=at(jgppo, gail_horizon), gail=gcfg, jgail=jgcfg)


class Holder:
    """The port's env held to the JAX env step by step: the starts, the
    step, the flags; one row a vector step."""

    def __init__(self, env, n: int):
        self.env, self.n = env, n

    def t(self, x):
        import numpy as np
        import torch

        return torch.from_numpy(np.array(x))

    def start_ulps(self, keys, want_obs) -> float:
        """The port's reset from ``key_reset_draw`` of each JAX reset key
        against JAX's start observations."""
        import numpy as np
        import torch

        keys = np.asarray(keys)
        if not len(keys):
            return 0.0
        draw = torch.cat([self.env.key_reset_draw(k) for k in keys])
        _, obs = self.env.reset(draw)
        return env_ulps(obs.numpy(), want_obs, OBS_BOUNDS)

    def reset_keys(self, key):
        """The reset keys ``vec_reset`` gives each env."""
        import jax

        return jax.random.split(key, self.n)

    def auto_reset_keys(self, k_step):
        """The reset key each env's ``step_auto_reset`` takes from the
        vector step's key."""
        import jax

        return jax.vmap(lambda k: jax.random.split(k)[1])(
            jax.random.split(k_step, self.n))

    def step(self, env_state, action, out, k_step) -> dict:
        """The port's step from JAX's state with JAX's action, and its
        auto-reset starts from JAX's keys."""
        import numpy as np

        from freerl_tpu_torch.envs.classic import PendulumState

        state = PendulumState(theta=self.t(env_state.theta),
                              theta_dot=self.t(env_state.theta_dot),
                              t=self.t(env_state.t))
        _, obs, rew, term, trunc = self.env.step(state, self.t(action), None)
        done = np.asarray(out.episode_done)
        keys = np.asarray(self.auto_reset_keys(k_step))[done]
        return dict(
            reset_ulps=self.start_ulps(keys, np.asarray(out.carry_obs)[done]),
            env_ulps=max(env_ulps(obs.numpy(), out.next_obs, OBS_BOUNDS),
                         env_ulps(rew.numpy(), out.reward, REWARD_BOUND)),
            env_flags=int((term.numpy() != np.asarray(out.terminated)).sum()
                          + (trunc.numpy() != np.asarray(out.truncated)).sum()))


def step_verdict(row: dict) -> str:
    """A vector step's verdict: every relative gap within ``RTOL``, the
    starts and the env within ``START_ULPS`` ulps, the same flags."""
    ok = (max(row.get(k, 0.0) for k in STEP_ORDER if k.endswith("_rel"))
          <= RTOL and max(row["reset_ulps"], row["env_ulps"])
          <= START_ULPS and row["env_flags"] == 0)
    return "within" if ok else "fault"


def past(row: dict, key: str) -> bool:
    """Whether one quantity of a row is past its tolerance."""
    if key.endswith("_ulps"):
        return row[key] > START_ULPS
    if key == "env_flags":
        return row[key] != 0
    if key == "d_params_abs":
        return row["d_step"] != "within"
    if key == "params_abs":
        return row["update"] not in ("within", "float32",
                                     "float64 rounding")
    return row[key] > RTOL


def policy_rel(algo, state, obs, drew) -> float:
    """The port's ``sample_action`` on JAX's observation and draws against
    JAX's env action, stored action and log-prob, at unit scale."""
    import numpy as np
    import torch

    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    got = algo.sample_action(state, t(obs), t(drew["eps"]))
    return max(rel_err(g, drew[k], 1.0)
               for g, k in zip(got, ("env_a", "stored_a", "logp")))


def hold_update(jalgo, algo, state, jpre, jnew, jroll, k_upd,
                episodes) -> dict:
    """One update from JAX's state on JAX's rollout: GAE, then the lr and
    the params, the update's verdict (C16's rule, the float64 rerun where
    the params miss it; a fault where the lr does)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from freerl_tpu.algos.common import gae as jax_gae
    from freerl_tpu_torch.algos.common import gae
    from freerl_tpu_torch.algos.ppo import Rollout

    cfg = jalgo.cfg
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    load_jax_state(algo, state, jpre)
    jadv, jvt = jax.jit(lambda s, r: jax_gae(
        r.reward, jalgo.value(s, r.obs), jalgo.value(s, r.next_obs),
        r.done.astype(jnp.float32), r.adv_done.astype(jnp.float32),
        cfg.gamma, cfg.lmbda))(jpre, jroll)
    roll = Rollout(**{f: t(getattr(jroll, f))
                      for f in Rollout.__dataclass_fields__})
    with torch.no_grad():
        adv, vt = gae(roll.reward, state.critic(roll.obs),
                      state.critic(roll.next_obs), roll.done, roll.adv_done,
                      cfg.gamma, cfg.lmbda)
    T, n = np.shape(jroll.reward)
    perms, kk = [], k_upd
    for _ in range(cfg.K_epochs):
        kk, k_perm = jax.random.split(kk)
        perms.append(np.asarray(jax.random.permutation(k_perm, T * n)))
    perms = torch.from_numpy(np.stack(perms).astype(np.int64))
    state, _ = algo.update(state, roll, perms,
                           episodes=torch.tensor(int(episodes)))
    gap, n_past, total = params_gap(state, jnew)
    jlr = float(np.asarray(jnew.opt_state.hyperparams["learning_rate"]))
    row = dict(episodes=int(episodes),
               lr=state.opt.param_groups[0]["lr"], jax_lr=jlr,
               lr_rel=rel_err(state.opt.param_groups[0]["lr"], jlr),
               gae_adv_rel=rel_err(adv, jadv, rms(jvt)),
               gae_target_rel=rel_err(vt, jvt, rms(jvt)),
               params_abs=gap, params_past_atol=n_past, params_total=total,
               update="within")
    if not (n_past * PAST_ONE_IN <= total and gap <= cfg.actor_lr):
        f64 = updates_f64(jalgo, algo, jpre, jroll, k_upd, perms, episodes)
        row.update(params_f64_abs=f64["f64"],
                   params_f64_twin_abs=f64["f64_twin"])
        row["update_rule"] = ("float32" if f64["f64"] <= ATOL_F64
                              else "fault")
        row["update"] = (row["update_rule"] if f64["f64"] <= ATOL_F64
                         else "float64 rounding" if f64["f64"]
                         <= TWIN_FACTOR * f64["f64_twin"] else "fault")
    if row["lr_rel"] > RTOL:
        row["update"] = "fault"
    row["gae"] = ("within" if max(row["gae_adv_rel"], row["gae_target_rel"])
                  <= RTOL else "fault")
    return row


def expert_lockstep(cf: dict, iterations: int, seed: int) -> dict:
    """The expert's first ``iterations`` iterations (module doc, 1-5 and
    the updates); returns the rows and JAX's state after them."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from freerl_tpu.algos.ppo import PPO as JaxPPO
    from freerl_tpu.algos.ppo import Rollout as JaxRollout
    from freerl_tpu.envs import make as jax_make
    from freerl_tpu.envs import vec_reset, vec_step_auto_reset
    from freerl_tpu_torch.algos import PPO
    from freerl_tpu_torch.core.normalization import (RewardScaling,
                                                     RunningMeanStd)
    from freerl_tpu_torch.envs import make

    jenv, env = jax_make(ENV), make(ENV, device="cpu")
    jalgo = JaxPPO(jenv.dim_info, cf["jexpert"])
    algo = PPO(env.dim_info, cf["expert"], device="cpu")
    n = cf["expert"].num_envs
    T = max(cf["expert"].horizon // n, 1)
    hold = Holder(env, n)
    t = hold.t

    key = jax.random.PRNGKey(seed)
    k_algo, k_env, key = jax.random.split(key, 3)
    jstate = jalgo.init(k_algo)
    env_state, raw = vec_reset(jenv, k_env, n)
    reset_ulps = hold.start_ulps(hold.reset_keys(k_env), np.asarray(raw))
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
        return k, k_step, jstate, out, reward, next_obs, carry_obs, dict(
            env_a=env_a, stored_a=stored_a, logp=logp, eps=eps)

    @jax.jit
    def j_update(jstate, roll, key, episodes):
        k, k_upd = jax.random.split(key)
        new, _ = jalgo.update(jstate, roll, k_upd, episodes=episodes)
        return k, k_upd, new

    norm = RunningMeanStd.create((env.dim_info.obs_dim,), "cpu").update(
        t(raw))
    scaling = RewardScaling.create(n, cf["expert"].gamma, "cpu")
    norm_rel = max(
        rel_err(norm.normalize(t(raw)), obs, 1.0),
        rel_err(norm.mean, jstate.obs_rms.mean, np.sqrt(jstate.obs_rms.var)),
        rel_err(norm.var, jstate.obs_rms.var))
    state = algo.init(torch.Generator().manual_seed(0))
    ep_return = np.zeros(n, np.float32)
    returns, steps, updates = [], [], []
    for it in range(1, iterations + 1):
        load_jax_state(algo, state, jstate)
        rows = []
        for s in range(T):
            carry_obs = obs
            pre_state = env_state
            key, k_step, jstate, out, reward, next_obs, obs, drew = j_step(
                jstate, env_state, obs, key)
            row = dict(iteration=it, step=s + 1,
                       policy_rel=policy_rel(algo, state, carry_obs, drew),
                       **hold.step(pre_state, drew["env_a"], out, k_step))
            scaling, scaled = scaling(t(out.reward), t(out.episode_done))
            jrs = jstate.rew_scale
            row.update(
                scaling_ret_rel=rel_err(scaling.ret, jrs.ret, rms(jrs.ret)),
                scaling_stats_rel=max(
                    rel_err(scaling.stats.mean, jrs.stats.mean,
                            np.sqrt(jrs.stats.var)),
                    rel_err(scaling.stats.var, jrs.stats.var),
                    rel_err(scaling.stats.count, jrs.stats.count)),
                scaled_rel=rel_err(scaled, reward, rms(reward)))
            norm = norm.update(t(out.next_obs))
            jr = jstate.obs_rms
            row.update(
                norm_stats_rel=max(
                    rel_err(norm.mean, jr.mean, np.sqrt(jr.var)),
                    rel_err(norm.var, jr.var), rel_err(norm.count, jr.count)),
                normalized_rel=max(
                    rel_err(norm.normalize(t(out.next_obs)), next_obs, 1.0),
                    rel_err(norm.normalize(t(out.carry_obs)), obs, 1.0)))
            row["verdict"] = step_verdict(row)
            rows.append(row)
            env_state = out.state
            ep_return = ep_return + np.asarray(out.reward)
            done = np.asarray(out.episode_done)
            returns += [float(x) for x in ep_return[done]]
            ep_return = np.where(done, 0.0, ep_return).astype(np.float32)
            steps.append(JaxRollout(
                obs=carry_obs, action=drew["stored_a"], log_pi=drew["logp"],
                reward=reward, next_obs=next_obs, done=out.terminated,
                adv_done=out.episode_done))
        jroll = jax.tree.map(lambda *x: jnp.stack(x), *steps)
        steps = []
        episodes = jnp.int32(len(returns))
        jpre = jstate
        key, k_upd, jstate = j_update(jstate, jroll, key, episodes)
        upd = hold_update(jalgo, algo, state, jpre, jstate, jroll, k_upd,
                          episodes)
        upd.update(iteration=it, steps=(
            "within" if all(r["verdict"] == "within" for r in rows)
            else "fault"))
        updates.append(upd)
        print(json.dumps({k: upd[k] for k in (
            "iteration", "episodes", "steps", "gae", "update",
            "params_abs")}), flush=True)
        upd["step_rows"] = rows
    return dict(reset_ulps=reset_ulps, reset_norm_rel=norm_rel,
                vector_steps=T, num_envs=n, updates=updates,
                returns=returns, jax_state=jstate, jalgo=jalgo)


def gail_lockstep(cf: dict, seed: int, jexpert_state, jexpert,
                  n_expert: int) -> dict:
    """One GAIL iteration (module doc, 1-3, the D step, the relabel and
    the PPO update) on an expert set the JAX package's
    ``collect_expert_data`` rolls from JAX's expert after the lockstep."""
    import jax
    import numpy as np
    import torch

    from freerl_tpu.algos.gail import GAIL as JaxGAIL
    from freerl_tpu.algos.gail import collect_expert_data
    from freerl_tpu.algos.ppo import Rollout as JaxRollout
    from freerl_tpu.envs import make as jax_make
    from freerl_tpu.envs import vec_reset, vec_step_auto_reset
    from freerl_tpu_torch.algos import GAIL
    from freerl_tpu_torch.convert import gail_disc_params_from_flax
    from freerl_tpu_torch.envs import make

    jenv, env = jax_make(ENV), make(ENV, device="cpu")
    jgail = JaxGAIL(jenv.dim_info, cf["jgail_ppo"], cf["jgail"])
    gail = GAIL(env.dim_info, cf["gail_ppo"], cf["gail"], device="cpu")
    jppo, ppo = jgail.ppo, gail.ppo
    n = cf["gail_ppo"].num_envs
    T = max(cf["gail_ppo"].horizon // n, 1)
    hold = Holder(env, n)
    t = hold.t
    expert = collect_expert_data(
        jenv, lambda o: jexpert.evaluate_action(jexpert_state, o), n_expert,
        seed=seed)

    key = jax.random.PRNGKey(seed + 1)
    k_init, k_env, k_loop = jax.random.split(key, 3)
    jgs = jgail.init(k_init)
    env_state, obs = vec_reset(jenv, k_env, n)
    reset_ulps = hold.start_ulps(hold.reset_keys(k_env), np.asarray(obs))
    _, k_roll, k_d, k_upd = jax.random.split(k_loop, 4)

    @jax.jit
    def j_step(ppo_state, env_state, obs, kk):
        env_a, stored_a, logp = jppo.sample_action(ppo_state, obs, kk)
        eps = jax.random.normal(kk, env_a.shape)
        out = vec_step_auto_reset(jenv, env_state, env_a, kk, n)
        return out, dict(env_a=env_a, stored_a=stored_a, logp=logp, eps=eps)

    gs = gail.init(torch.Generator().manual_seed(0))
    load_jax_state(ppo, gs.ppo_state, jgs.ppo_state)
    rows, steps = [], []
    for s in range(T):
        kk = jax.random.fold_in(k_roll, s)
        pre = env_state
        out, drew = j_step(jgs.ppo_state, env_state, obs, kk)
        row = dict(step=s + 1,
                   policy_rel=policy_rel(ppo, gs.ppo_state, obs, drew),
                   **hold.step(pre, drew["env_a"], out, kk))
        row["verdict"] = step_verdict(row)
        rows.append(row)
        steps.append((obs, drew["stored_a"], drew["logp"], out.reward,
                      out.next_obs, out.terminated, out.episode_done))
        env_state, obs = out.state, out.carry_obs
    obs_t, act_t, logp_t, true_r, next_obs_t, done_t, ep_done_t = (
        np.stack([np.asarray(x) for x in xs]) for xs in zip(*steps))
    flat_s = obs_t.reshape(-1, obs_t.shape[-1])
    flat_a = act_t.reshape(-1, act_t.shape[-1])

    # the D step on JAX's batches, from JAX's initial D
    ke, kp = jax.random.split(jax.random.fold_in(k_d, 0))
    e_s, e_a = expert.sample(ke, cf["gail"].d_batch_size)
    idx = np.asarray(jax.random.randint(kp, (cf["gail"].d_batch_size,), 0,
                                        flat_s.shape[0]))
    jgs2, _ = jax.jit(jgail.train_d)(jgs, e_s, e_a, flat_s[idx],
                                     flat_a[idx])
    gs.disc.load_state_dict(gail_disc_params_from_flax(
        jax.tree.map(np.asarray, jgs.d_params)))
    gs, _ = gail.train_d(gs, t(e_s), t(e_a), t(flat_s[idx]), t(flat_a[idx]))
    want = gail_disc_params_from_flax(jax.tree.map(np.asarray,
                                                   jgs2.d_params))
    got = gs.disc.state_dict()
    d_gap = max(float((got[k] - w).abs().max()) for k, w in want.items())
    d_past = sum(int(((got[k] - w).abs() > ATOL_PARAMS).sum())
                 for k, w in want.items())
    d_total = sum(w.numel() for w in want.values())

    # the relabel by the updated D, both on JAX's updated params
    jr = np.asarray(jgail.compute_reward(jgs2.d_params, flat_s, flat_a)
                    ).reshape(true_r.shape)
    gs.disc.load_state_dict(want)
    pr = gail.compute_reward(gs.disc, t(flat_s), t(flat_a)).reshape(
        true_r.shape)
    relabel = rel_err(pr, jr, rms(jr))

    jroll = JaxRollout(obs=obs_t, action=act_t, log_pi=logp_t, reward=jr,
                       next_obs=next_obs_t, done=done_t, adv_done=ep_done_t)
    jroll = jax.tree.map(jax.numpy.asarray, jroll)
    jnew, _ = jax.jit(lambda s, r, k: jppo.update(s, r, k))(
        jgs2.ppo_state, jroll, k_upd)
    upd = hold_update(jppo, ppo, gs.ppo_state, jgs2.ppo_state, jnew, jroll,
                      k_upd, 0)
    upd.update(
        iteration=1, reset_ulps=reset_ulps, d_params_abs=d_gap,
        d_params_past_atol=d_past, d_params_total=d_total,
        d_step=("within" if d_past * PAST_ONE_IN <= d_total
                and d_gap <= cf["gail"].d_lr else "fault"),
        relabel_rel=relabel,
        relabel="within" if relabel <= RTOL else "fault",
        steps="within" if all(r["verdict"] == "within" for r in rows)
        else "fault", step_rows=rows, vector_steps=T, num_envs=n,
        n_expert=n_expert, mean_true_reward=float(np.mean(true_r)))
    return upd


def first_fault(out: dict):
    """The first quantity past its tolerance, in the order the path
    computes them: the expert's steps and update iteration by iteration,
    then (where ``out`` has it) GAIL's steps, D step, relabel and update;
    None where none is."""
    if out["reset_ulps"] > START_ULPS:
        return dict(phase="expert", iteration=0, step=0,
                    quantity="reset_ulps")
    if out["reset_norm_rel"] > RTOL:
        return dict(phase="expert", iteration=0, step=0,
                    quantity="normalized_rel")
    phases = [("expert", u) for u in out["expert"]]
    if "gail" in out:
        phases.append(("gail", out["gail"]))
    for phase, upd in phases:
        for r in upd["step_rows"]:
            for q in STEP_ORDER:
                if q in r and past(r, q):
                    return dict(phase=phase, iteration=upd["iteration"],
                                step=r["step"], quantity=q)
        for q in UPDATE_ORDER:
            if q in upd and past(upd, q):
                return dict(phase=phase, iteration=upd["iteration"],
                            step=None, quantity=q)
    return None


def verdict(out: dict, key: str = "update") -> str:
    """C16's rule over the expert's updates and GAIL's, with GAIL's D step
    and relabel within too: ``agree`` or ``fault``."""
    rows = out["expert"] + [out["gail"]]
    ok = (c16_verdict(rows, key) == "agree"
          and out["gail"]["d_step"] == out["gail"]["relabel"] == "within"
          and out["reset_ulps"] <= START_ULPS
          and out["reset_norm_rel"] <= RTOL)
    return "agree" if ok else "fault"


def committed_expert_curve(seed: int):
    """The JAX side's kept expert curve of ``seed``, or None."""
    import numpy as np

    path = os.path.join(ROOT, "results", "torch", "jax_head", "gail", ENV,
                        f"GAIL_seed_{seed}", "expert_curve.npy")
    return np.load(path) if os.path.isfile(path) else None


def lockstep(iterations: int = 8, seed: int = 0, num_envs: int = 8,
             expert_horizon: int = 400, gail_horizon: int = 2048,
             n_expert: int = N_EXPERT, expert_episodes: int = 3000) -> dict:
    """The expert's ``iterations`` iterations, then one GAIL iteration;
    the record (module doc)."""
    import numpy as np
    import torch

    torch.set_num_threads(1)
    cf = configs(seed, expert_episodes, num_envs, expert_horizon,
                 gail_horizon)
    ex = expert_lockstep(cf, iterations, seed)
    gail = gail_lockstep(cf, seed, ex["jax_state"], ex["jalgo"], n_expert)
    out = dict(recipe=dict(EXPERT_RECIPE, lr_decay_episodes=expert_episodes,
                           num_envs=num_envs, horizon=expert_horizon),
               gail_recipe=dict(GAIL_RECIPE, **D_RECIPE,
                                num_envs=num_envs, horizon=gail_horizon),
               seed=seed, iterations=iterations,
               vector_steps=ex["vector_steps"], num_envs=ex["num_envs"],
               reset_ulps=ex["reset_ulps"],
               reset_norm_rel=ex["reset_norm_rel"], expert=ex["updates"],
               gail=gail, returns=ex["returns"])
    want = committed_expert_curve(seed)
    got = np.asarray(ex["returns"], np.float32)
    if want is not None and len(got):
        m = min(len(got), len(want))
        out["curve"] = dict(episodes=len(got),
                            bit_equal=bool(np.array_equal(got[:m],
                                                          want[:m])),
                            max_abs=float(np.abs(got[:m].astype(np.float64)
                                                 - want[:m]).max()))
    out["first_fault"] = first_fault(out)
    out["verdict"] = verdict(out)
    out["verdict_rule"] = verdict(out, "update_rule")
    out["tolerances"] = dict(rtol=RTOL, atol_params=ATOL_PARAMS,
                             past_one_in=PAST_ONE_IN, atol_f64=ATOL_F64,
                             twin_factor=TWIN_FACTOR,
                             start_ulps=START_ULPS)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    out = lockstep(args.iterations, args.seed)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out.get(k) for k in (
        "verdict", "verdict_rule", "first_fault", "curve")}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
