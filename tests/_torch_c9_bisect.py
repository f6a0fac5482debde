"""C9's bisection on the CPU: the golden DQN recipe (``golden._DQN_LL``:
LunarLander, 8 envs x 8 updates a vector step, batch 256, replay 1e6,
start_steps 500, epsilon 0.1) in the JAX package and in the port, step by
step down the rule ROADMAP fixes for C9.

    python -m tests._torch_c9_bisect frozen [--episodes 100] [--jobs 6]
    python -m tests._torch_c9_bisect lockstep [--steps 400] [--seed 0]
    python -m tests._torch_c9_bisect updates [--steps 400] [--seed 0]

``frozen``: every learning rate at 0, so what is left is the env, the
epsilon-greedy draw on a net at its init and the record. Each seed of
``golden.DQN_LL_SEEDS16`` runs the recipe in both packages for
``--episodes`` episodes (``--jobs`` processes at once); one JSON line gives
each side's per-seed mean return and env steps per episode, and the
two-sided Mann-Whitney p of each.

``lockstep``: the recipe's loop in both packages side by side from the
same init params, every random draw the JAX run's: its epsilon and
random-action draws, the env's engine dispersions and resets, and the
indices of every uniform replay sample (``fold_in(k_learn, i)`` for the
burst's i-th update, as ``freerl_tpu/train/loop.py`` derives them). The
port acts greedily on its own net and takes JAX's random draws; where its
greedy action differs from JAX's the step is counted and JAX's action is
taken, so the two stay on one trajectory. Beside it run three
yardsticks: a twin of the port whose every batch holds the same rows in
another order (the same updates up to float32 rounding of the batch
sums); a twin of the JAX learner fed the port env's transitions (its
distance from the JAX learner is how far the two envs' float32 rounding
alone carries it); and both learners in float64 (``jax.enable_x64``, and
the port's net and batches as float64), from the same init on the port's
replay and the same indices, so that the two float32 learners can each
be held to exact arithmetic. One JSON line gives, at each checkpoint, the
largest parameter difference from JAX (``params``), from the port's twin
(``params_twin``), between the two JAX learners
(``params_jax_on_port_data``), between the two float64 learners
(``params_f64``), and of each float32 learner from its package's float64
learner on the same transitions (``params_port_f32_f64``,
``params_jax_f32_f64``); the largest Q difference on the step's
observations (``q``: before this step's updates, from JAX; ``q_twin``:
after them, from the twin); the env's largest observation difference at
the step and largest reward difference so far; the greedy disagreements
so far; and, at the end, each replay field's largest difference between
the two packages' buffers.

``updates``: ``--steps`` updates one at a time on the port's replay after
the lockstep's first 70 vector steps, the JAX learner and the port's in
float32 and the port's in float64 from one init on the same batches
(``--seed`` seeds their indices): each update's losses and each float32
learner's distance from float64 in params, Adam's first moment and the
target, and where the JAX learner's gradient first jumps, the ReLU input
nearest zero and the sign flips of each float32 learner (``updates``).

This module imports both packages, as the tests do;
``tests/test_torch_golden_recipe.py`` runs its lockstep.
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


def _recipe(seed: int):
    from freerl_tpu_torch import cli
    from freerl_tpu_torch.train.golden import _DQN_LL

    return cli.parser().parse_args(
        [a.format(seed=seed) for a in _DQN_LL] + ["--device", "cpu"])


def frozen_run(side: str, seed: int, episodes: int) -> dict:
    """One seed of the recipe with every learning rate at 0."""
    import numpy as np

    args = _recipe(seed)
    kw = dict(seed=seed, num_envs=args.num_envs, max_episodes=episodes,
              start_steps=args.start_steps,
              updates_per_burst=args.updates_per_burst)
    if side == "jax":
        from freerl_tpu import cli as jax_cli
        from freerl_tpu.train.loop import OffPolicyConfig, train_offpolicy

        env, algo = jax_cli.build(args)
        algo = type(algo)(env.dim_info, dataclasses.replace(algo.cfg,
                                                            lr=0.0))
    else:
        import torch

        from freerl_tpu_torch import cli
        from freerl_tpu_torch.train import OffPolicyConfig, train_offpolicy

        torch.set_num_threads(1)
        env, algo = cli.build(args)
        algo = type(algo)(env.dim_info, dataclasses.replace(algo.cfg,
                                                            lr=0.0),
                          device="cpu")
    _, returns, info = train_offpolicy(env, algo, OffPolicyConfig(**kw))
    returns = np.asarray(returns)[:episodes]
    return dict(side=side, seed=seed, mean_return=float(returns.mean()),
                steps_per_episode=info["env_steps"] / info["episodes"])


def _frozen_job(job):
    return frozen_run(*job)


def frozen(episodes: int, jobs: int) -> dict:
    import multiprocessing

    from scipy.stats import mannwhitneyu

    from freerl_tpu_torch.train.golden import DQN_LL_SEEDS16

    work = [(side, s, episodes) for s in DQN_LL_SEEDS16
            for side in ("jax", "port")]
    with multiprocessing.get_context("spawn").Pool(jobs) as pool:
        rows = pool.map(_frozen_job, work, chunksize=1)
    out = {"episodes": episodes, "seeds": list(DQN_LL_SEEDS16)}
    for side in ("jax", "port"):
        mine = [r for r in rows if r["side"] == side]
        out[side] = {k: [r[k] for r in mine]
                     for k in ("mean_return", "steps_per_episode")}
    for k in ("mean_return", "steps_per_episode"):
        res = mannwhitneyu(out["jax"][k], out["port"][k],
                           alternative="two-sided")
        out[f"p_{k}"] = float(res.pvalue)
    return out


def lockstep(steps: int, every: int = 25, seed: int = 0,
             keep: dict | None = None) -> dict:
    """The recipe's loop in both packages on JAX's draws, a checkpoint
    row every ``every`` vector steps. ``keep``, a dict, receives both
    algos, the port's replay and the initial states."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from freerl_tpu import cli as jax_cli
    from freerl_tpu.algos.base import ExploreCtx as JaxExploreCtx
    from freerl_tpu.core.types import Transition as JaxTransition
    from freerl_tpu.envs import vec_reset as jax_vec_reset
    from freerl_tpu.envs import vec_step_auto_reset as jax_vec_step
    from freerl_tpu_torch import cli
    from freerl_tpu_torch.convert import dqn_params_from_flax
    from freerl_tpu_torch.core.types import Transition
    from freerl_tpu_torch.envs import step_auto_reset
    from tests.test_torch_lunar_lander import (jax_auto_reset_draws,
                                               jax_reset_draw)

    torch.set_num_threads(1)
    args = _recipe(seed)
    n, n_up = args.num_envs, args.updates_per_burst
    jenv, jalgo = jax_cli.build(args)
    env, algo = cli.build(args)
    cfg = jalgo.cfg
    assert (cfg.batch_size, cfg.explore_epsilon, cfg.per, cfg.n_step) == (
        256, 0.1, False, 1)

    k_algo, k_env, key = jax.random.split(jax.random.PRNGKey(seed), 3)
    jstate = jalgo.init(k_algo)
    example = JaxTransition(
        obs=jnp.zeros((8,), jnp.float32), action=jnp.zeros((), jnp.int32),
        reward=jnp.zeros((), jnp.float32),
        next_obs=jnp.zeros((8,), jnp.float32),
        done=jnp.zeros((), jnp.bool_), episode_done=jnp.zeros((), jnp.bool_))
    jbuf = jalgo.make_buffer(example, num_envs=n)
    jenv_state, jobs = jax_vec_reset(jenv, k_env, n)
    ctx = JaxExploreCtx(total_env_steps=jnp.int32(10_000),
                        episodes=jnp.int32(0),
                        done_prev=jnp.zeros((n,), jnp.bool_))

    @jax.jit
    def j_act(jstate, jobs, k_act):
        _, action = jalgo.explore(jstate, jobs, k_act, ctx)
        _, k_e, k_r = jax.random.split(k_act, 3)
        rand = jax.random.randint(k_r, (n,), 0, jalgo.dim_info.action_dim)
        use_rand = jax.random.uniform(k_e, (n,)) < cfg.explore_epsilon
        return action, rand, use_rand, jalgo._q_values(jstate.params, jobs)

    @jax.jit
    def j_env(jenv_state, jobs, action, k_step, jbuf):
        out = jax_vec_step(jenv, jenv_state, action, k_step, n)
        jbuf = jbuf.add(JaxTransition(
            obs=jobs, action=action, reward=out.reward,
            next_obs=out.next_obs, done=out.terminated,
            episode_done=out.episode_done))
        return out, jbuf

    @jax.jit
    def j_learn(jstate, jbuf, k_learn):
        idxs = []
        for i in range(n_up):
            kk = jax.random.fold_in(k_learn, i)
            k_s, _ = jax.random.split(kk)
            idxs.append(jax.random.randint(k_s, (cfg.batch_size,), 0,
                                           jbuf.size))
            jstate, jbuf, _ = jalgo.learn_step(jstate, jbuf, kk, n)
        return jstate, jbuf, jnp.stack(idxs)

    # the yardstick for the data: the JAX learner fed the port env's
    # transitions, beside the JAX learner on its own
    jstate2, jbuf2 = jstate, jalgo.make_buffer(example, num_envs=n)
    j_add = jax.jit(lambda b, t: b.add(t))

    # the yardstick of exact arithmetic: both learners in float64 on the
    # port's replay, each float32 learner held to its own package's
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x), jnp.float64),
                           jstate.params)
        j64 = type(jstate)(params=p64, target_params=p64,
                           opt_state=jalgo.tx.init(p64), step=jstate.step)
        j_update64 = jax.jit(jalgo.update)

    state = algo.init(torch.Generator().manual_seed(0))
    sd = dqn_params_from_flax(jax.tree.map(np.asarray, jstate.params))
    s64 = algo.init(torch.Generator().manual_seed(3))
    s64.net.load_state_dict(sd)
    s64.target_net.load_state_dict(sd)
    s64.net.to(torch.float64)
    s64.target_net.to(torch.float64)
    state.net.load_state_dict(sd)
    state.target_net.load_state_dict(sd)
    buf = algo.make_buffer(Transition(
        obs=torch.zeros(8), action=torch.zeros((), dtype=torch.int32),
        reward=torch.zeros(()), next_obs=torch.zeros(8),
        done=torch.zeros((), dtype=torch.bool),
        episode_done=torch.zeros((), dtype=torch.bool)), num_envs=n)
    f0 = jax.vmap(jax_reset_draw)(jax.random.split(k_env, n))
    env_state, obs = env.reset(torch.from_numpy(np.array(f0)))

    # the float-noise yardstick: a second port run whose every batch is
    # the same rows in another order (the same update up to rounding)
    twin = algo.init(torch.Generator().manual_seed(1))
    twin.net.load_state_dict(sd)
    twin.target_net.load_state_dict(sd)
    perm = torch.randperm(cfg.batch_size,
                          generator=torch.Generator().manual_seed(2))

    def params_diff(want, net=None):
        got = (net or state.net).state_dict()
        return max(float((v.double() - want[k].double()).abs().max())
                   for k, v in got.items())

    def tree_diff(a, b):
        return max(float(np.abs(np.asarray(x, np.float64)
                                - np.asarray(y, np.float64)).max())
                   for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))

    def port64(tree):
        # the converter rounds to float32: convert the float32 part and
        # the remainder apart and add them in float64
        hi = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
        lo = jax.tree.map(lambda x, h: np.asarray(
            np.asarray(x, np.float64) - h, np.float32), tree, hi)
        hi, lo = dqn_params_from_flax(hi), dqn_params_from_flax(lo)
        return {k: hi[k].double() + lo[k].double() for k in hi}

    def batch64(b):
        return Transition(obs=b.obs.double(), action=b.action,
                          reward=b.reward.double(),
                          next_obs=b.next_obs.double(), done=b.done,
                          episode_done=b.episode_done)

    rows, disagree, updates, reward_diff = [], 0, 0, 0.0
    for t in range(1, steps + 1):
        key, k_act, k_step, k_learn = jax.random.split(key, 4)
        jaction, rand, use_rand, jq = j_act(jstate, jobs, k_act)
        with torch.no_grad():
            q = algo.q_values(state.net, obs)
        greedy = torch.argmax(q, -1)
        mine = torch.where(torch.from_numpy(np.array(use_rand)),
                           torch.from_numpy(np.array(rand)).to(greedy.dtype),
                           greedy)
        disagree += int((mine.numpy() != np.asarray(jaction)).sum())
        action = torch.from_numpy(np.array(jaction)).to(torch.int64)
        jout, jbuf = j_env(jenv_state, jobs, jaction, k_step, jbuf)
        disp, f = jax_auto_reset_draws(k_step, n)
        out = step_auto_reset(env, env_state, action, disp, f)
        buf.add(Transition(obs=obs, action=action.to(torch.int32),
                           reward=out.reward, next_obs=out.next_obs,
                           done=out.terminated,
                           episode_done=out.episode_done))
        jbuf2 = j_add(jbuf2, JaxTransition(
            obs=jnp.asarray(obs.numpy()), action=jaction,
            reward=jnp.asarray(out.reward.numpy()),
            next_obs=jnp.asarray(out.next_obs.numpy()),
            done=jnp.asarray(out.terminated.numpy()),
            episode_done=jnp.asarray(out.episode_done.numpy())))
        reward_diff = max(reward_diff, float(np.abs(
            out.reward.numpy() - np.asarray(jout.reward)).max()))
        env_state, obs = out.state, out.carry_obs
        jenv_state, jobs = jout.state, jout.carry_obs
        if t * n > args.start_steps:
            jstate, jbuf, idxs = j_learn(jstate, jbuf, k_learn)
            jstate2, jbuf2, _ = j_learn(jstate2, jbuf2, k_learn)
            for idx in np.asarray(idxs):
                idx = torch.from_numpy(idx.copy()).to(torch.int64)
                batch = buf.gather(idx)
                state, _, _ = algo.update(state, batch)
                twin, _, _ = algo.update(twin, buf.gather(idx[perm]))
                s64, _, _ = algo.update(s64, batch64(batch))
                with jax.enable_x64(True):
                    j64, _, _ = j_update64(j64, JaxTransition(
                        **{f: jnp.asarray(getattr(batch64(batch), f).numpy())
                           for f in ("obs", "action", "reward", "next_obs",
                                     "done", "episode_done")}))
                updates += 1
        if t % every == 0 or t == steps:
            with torch.no_grad():
                q_twin = algo.q_values(twin.net, obs)
                q_now = algo.q_values(state.net, obs)
            rows.append(dict(
                step=t, updates=updates,
                params=params_diff(dqn_params_from_flax(
                    jax.tree.map(np.asarray, jstate.params))),
                params_twin=params_diff(twin.net.state_dict()),
                params_jax_on_port_data=tree_diff(jstate.params,
                                                  jstate2.params),
                params_f64=params_diff(port64(j64.params), s64.net),
                params_port_f32_f64=params_diff(s64.net.state_dict()),
                params_jax_f32_f64=tree_diff(
                    jstate2.params, j64.params),
                q=float(np.abs(q.numpy() - np.asarray(jq)).max()),
                q_twin=float((q_now - q_twin).abs().max()),
                obs=float(np.abs(obs.numpy() - np.asarray(jobs)).max()),
                reward=reward_diff,
                greedy_disagreements=disagree))
    size = int(jbuf.size)
    replay = {}
    for f in ("obs", "action", "reward", "next_obs", "done",
              "episode_done"):
        a = getattr(buf.data, f)[:size].numpy().astype(np.float64)
        b = np.asarray(getattr(jbuf.data, f))[:size].astype(np.float64)
        replay[f] = float(np.abs(a - b).max())
    if keep is not None:
        keep.update(jalgo=jalgo, algo=algo, buf=buf, sd=sd,
                    jinit=jalgo.init(k_algo))
    return {"steps": steps, "num_envs": n, "rows": rows, "replay": replay}


def updates(n_updates: int = 64, seed: int = 1) -> dict:
    """One update at a time, from one init, on the port's replay after
    the lockstep's first 70 vector steps (560 transitions): the JAX
    learner and the port's in float32, and the port's in float64 as exact
    arithmetic, each on the same uniform batch of 256 (indices from
    ``numpy.random.default_rng(seed)``). Per update: each learner's loss,
    and each float32 learner's largest difference from the float64 one in
    params, Adam's first moment and the target params. At the first update
    where the JAX learner's first-moment distance from float64 grows more
    than fourfold (and past 1e-5: its gradient jumped), the batch's
    first-layer ReLU inputs in float64 are read before the update: the
    smallest in magnitude, and how many take the other sign under each
    float32 learner's params."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from freerl_tpu.core.types import Transition as JaxTransition
    from freerl_tpu_torch.convert import dqn_params_from_flax

    keep = {}
    lockstep(70, every=70, keep=keep)
    jalgo, algo, buf = keep["jalgo"], keep["algo"], keep["buf"]
    jstate = keep["jinit"]
    size = int(buf.size)
    nets = []
    for dtype in (torch.float32, torch.float64):
        st = algo.init(torch.Generator().manual_seed(0))
        for net in (st.net, st.target_net):
            net.load_state_dict(keep["sd"])
            net.to(dtype)
        nets.append(st)
    state, s64 = nets
    j_update = jax.jit(jalgo.update)
    rng = np.random.default_rng(seed)

    def port(tree):
        return {k: v.double() for k, v in dqn_params_from_flax(
            jax.tree.map(np.asarray, tree)).items()}

    def dist(a, b):
        return max(float((a[k].double() - b[k]).abs().max()) for k in b)

    def moments(st):
        return {k: st.opt.state[p]["exp_avg"].double()
                for k, p in st.net.named_parameters()}

    def first_layer(params, obs):
        return obs @ params["hidden.0.weight"].double().T + params[
            "hidden.0.bias"].double()

    rows, kink, prev = [], None, 0.0
    for i in range(1, n_updates + 1):
        idx = torch.from_numpy(rng.integers(0, size, 256)).to(torch.int64)
        batch = buf.gather(idx)
        b64 = type(batch)(obs=batch.obs.double(), action=batch.action,
                          reward=batch.reward.double(),
                          next_obs=batch.next_obs.double(), done=batch.done,
                          episode_done=batch.episode_done)
        # each learner's params before this update
        pre = dict(jax=port(jstate.params),
                   port={k: v.clone() for k, v in
                         state.net.state_dict().items()},
                   f64={k: v.clone() for k, v in
                        s64.net.state_dict().items()})
        jstate, jm, _ = j_update(jstate, JaxTransition(
            **{f: jnp.asarray(getattr(batch, f).numpy())
               for f in ("obs", "action", "reward", "next_obs", "done",
                         "episode_done")}))
        state, m, _ = algo.update(state, batch)
        s64, m64, _ = algo.update(s64, b64)
        want, want_m = s64.net.state_dict(), moments(s64)
        want_t = s64.target_net.state_dict()
        row = dict(
            update=i, loss_jax=float(jm["loss"]), loss_port=float(m["loss"]),
            loss_f64=float(m64["loss"]),
            params_jax=dist(port(jstate.params), want),
            params_port=dist(state.net.state_dict(), want),
            adam_m_jax=dist(port(jstate.opt_state[0].mu), want_m),
            adam_m_port=dist(moments(state), want_m),
            target_jax=dist(port(jstate.target_params), want_t),
            target_port=dist(state.target_net.state_dict(), want_t))
        rows.append(row)
        if kink is None and row["adam_m_jax"] > max(4 * prev, 1e-5):
            exact = first_layer(pre["f64"], b64.obs)
            at = int(exact.abs().argmin())
            kink = dict(update=i,
                        relu_input_f64=float(exact.flatten()[at]))
            for name in ("jax", "port"):
                got = first_layer(pre[name], b64.obs)
                kink[f"relu_input_{name}"] = float(got.flatten()[at])
                kink[f"sign_flips_{name}"] = int(
                    ((got > 0) != (exact > 0)).sum())
        prev = row["adam_m_jax"]
    return {"seed": seed, "rows": rows, "kink": kink}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("frozen", "lockstep", "updates"))
    ap.add_argument("--episodes", type=int, default=100)
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.mode == "frozen":
        out = frozen(args.episodes, args.jobs)
    elif args.mode == "lockstep":
        out = lockstep(args.steps, seed=args.seed)
    else:
        out = updates(args.steps, seed=args.seed)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
