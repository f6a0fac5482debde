"""The golden DQN LunarLander recipe (``golden._DQN_LL``: 8 envs, 8 updates
per vector step, start_steps 500, epsilon 0.1, uniform replay, batch 256)
piece by piece against the JAX package, where its learning curve could
part from the JAX package's: the epsilon-greedy exploration on one net and
one batch of observations (statistics: the streams differ), the loop's
cadence (when learning starts and how many updates each vector step
takes), the range of a uniform replay sample, and the whole recipe for
its first 64 updates on the JAX run's draws (``tests/_torch_c9_bisect.py``'s
lockstep). The update, the polyak step and the env are held elsewhere
(``test_torch_dqn.py``, ``test_torch_slice.py``,
``test_torch_lunar_lander.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu import cli as jax_cli
from freerl_tpu.algos.base import ExploreCtx as JaxExploreCtx
from freerl_tpu.buffers.uniform import ReplayBuffer as JaxReplayBuffer
from freerl_tpu.core.types import Transition as JaxTransition
from freerl_tpu.train.loop import OffPolicyConfig as JaxOffPolicyConfig
from freerl_tpu.train.loop import train_offpolicy as jax_train_offpolicy
from freerl_tpu_torch import cli
from freerl_tpu_torch.algos import ExploreCtx
from freerl_tpu_torch.buffers import ReplayBuffer
from freerl_tpu_torch.convert import dqn_params_from_flax
from freerl_tpu_torch.core.types import Transition
from freerl_tpu_torch.train import OffPolicyConfig, train_offpolicy
from freerl_tpu_torch.train.golden import _DQN_LL

torch.set_num_threads(1)

ROWS = 40_000


def _recipe(**over):
    """The recipe's CLI arguments, seed 0, parsed by the port's CLI (which
    the JAX CLI's ``build`` accepts), with ``over`` replaced."""
    argv = [a.format(seed=0) for a in _DQN_LL] + ["--device", "cpu"]
    args = cli.parser().parse_args(argv)
    for k, v in over.items():
        setattr(args, k, v)
    return args


def test_epsilon_greedy_matches_jax():
    """On the same params and observations, both explore with the recipe's
    epsilon: the share of rows that leave the greedy action is
    eps * 3/4 in both (within 5 sigma), and those rows land on the three
    other actions alike."""
    args = _recipe(buffer_size=4096)
    jenv, jalgo = jax_cli.build(args)
    env, algo = cli.build(args)
    assert algo.cfg.explore_epsilon == jalgo.cfg.explore_epsilon == 0.1
    jstate = jalgo.init(jax.random.PRNGKey(0))
    state = algo.init(torch.Generator().manual_seed(0))
    state.net.load_state_dict(dqn_params_from_flax(
        jax.tree.map(np.asarray, jstate.params)))
    obs = np.random.RandomState(0).randn(ROWS, 8).astype(np.float32)
    greedy = np.asarray(jalgo.select_action(jstate, jnp.asarray(obs)))
    ctx = JaxExploreCtx(total_env_steps=jnp.int32(10_000),
                        episodes=jnp.int32(0),
                        done_prev=jnp.zeros((ROWS,), jnp.bool_))
    _, ja = jalgo.explore(jstate, jnp.asarray(obs), jax.random.PRNGKey(1),
                          ctx)
    tctx = ExploreCtx(total_env_steps=10_000, episodes=torch.tensor(0),
                      done_prev=torch.zeros(ROWS, dtype=torch.bool))
    _, ta = algo.explore(state, torch.from_numpy(obs),
                         torch.Generator().manual_seed(1), tctx)
    tgreedy = state.net(torch.from_numpy(obs)).argmax(-1).numpy()
    assert (tgreedy == greedy).mean() > 0.999
    p = 0.1 * 3 / 4
    sigma = np.sqrt(p * (1 - p) / ROWS)
    for acts in (np.asarray(ja), ta.numpy()):
        off = acts != greedy
        assert abs(off.mean() - p) < 5 * sigma
        # a random action lands on each of the 3 non-greedy actions alike
        counts = np.bincount((acts[off] - greedy[off]) % 4, minlength=4)[1:]
        assert counts.min() > 0.8 * counts.mean()


def test_recipe_cadence_matches_jax():
    """One chunk (256 vector steps) of the recipe's loop in both packages:
    the same env steps and updates (learning starts on the vector step
    past 500 env steps, 8 updates a step), and a finite record."""
    args = _recipe(buffer_size=4096)
    jenv, jalgo = jax_cli.build(args)
    env, algo = cli.build(args)
    common = dict(seed=0, num_envs=args.num_envs,
                  max_episodes=args.max_episodes,
                  start_steps=args.start_steps,
                  updates_per_burst=args.updates_per_burst,
                  max_env_steps=256 * args.num_envs)
    _, jrets, jinfo = jax_train_offpolicy(jenv, jalgo,
                                          JaxOffPolicyConfig(**common))
    _, rets, info = train_offpolicy(env, algo, OffPolicyConfig(**common))
    assert (info["env_steps"], info["updates"]) == (
        jinfo["env_steps"], jinfo["updates"]) == (2048, (256 - 62) * 8)
    assert np.isfinite(rets).all() and np.isfinite(np.asarray(jrets)).all()


@pytest.mark.parametrize("adds", [1, 3, 40])
def test_uniform_sample_range_matches_jax(adds):
    """After ``adds`` adds of the recipe's 8 rows into a 64-slot ring, both
    packages draw from exactly the filled slots."""
    ex = dict(obs=np.zeros(8, np.float32), action=np.zeros((), np.int32),
              reward=np.zeros((), np.float32),
              next_obs=np.zeros(8, np.float32), done=np.zeros((), bool),
              episode_done=np.zeros((), bool))
    jbuf = JaxReplayBuffer.create(64, JaxTransition(
        **{k: jnp.asarray(v) for k, v in ex.items()}), add_batch=8)
    buf = ReplayBuffer.create(64, Transition(
        **{k: torch.from_numpy(np.array(v)) for k, v in ex.items()}),
        add_batch=8)
    rows = {k: np.repeat(v[None], 8, 0) for k, v in ex.items()}
    for _ in range(adds):
        jbuf = jbuf.add(JaxTransition(
            **{k: jnp.asarray(v) for k, v in rows.items()}))
        buf = buf.add(Transition(
            **{k: torch.from_numpy(v) for k, v in rows.items()}))
    jidx = jax.random.randint(jax.random.PRNGKey(0), (20_000,), 0,
                              jbuf.size)
    idx = buf.sample_idx(torch.Generator().manual_seed(0), 20_000)
    want = set(range(min(8 * adds, 64)))
    assert set(np.asarray(jidx).tolist()) == set(idx.tolist()) == want


def test_recipe_lockstep_with_jax():
    """The recipe's own path (uniform replay, the default net, batch 256,
    8 updates a vector step from env step 504) in both packages on the JAX
    run's draws for 70 vector steps, 64 updates: same trajectory, no
    greedy disagreement, and the learners one function: run in float64 on
    the port's replay they agree to 1e-12 (measured 4.4e-16). In float32
    the port stays within 1e-6 of its float64 run (measured 2.5e-7; a
    permuted-batch twin 6e-8), so the port and JAX learners' float32 gap
    (measured 3.5e-5) is the JAX package's own float32 departure from
    float64 (measured 3.5e-5: its float32 update rounds more, and a ReLU
    input within rounding of zero then takes the other branch) and the two
    envs' rounding (4.9e-6), not a difference of the learners."""
    from tests._torch_c9_bisect import lockstep

    out = lockstep(70, every=70)
    last = out["rows"][-1]
    assert last["step"] == 70 and last["updates"] == 64
    assert last["greedy_disagreements"] == 0
    assert last["obs"] <= 1e-5 and last["reward"] <= 1e-3
    assert last["params_f64"] <= 1e-12
    assert last["params_port_f32_f64"] <= 1e-6
    assert last["params_twin"] <= 1e-6
    assert last["params_port_f32_f64"] < last["params_jax_f32_f64"]
    assert out["replay"]["done"] == 0.0 and out["replay"]["action"] == 0.0


def test_recipe_updates_one_by_one_against_float64():
    """The recipe's learners one update at a time on the port's replay
    from one init (``tests/_torch_c9_bisect.py``'s ``updates``): the
    losses agree to float32 rounding; the port's float32 learner stays
    within 1e-6 of its float64 run; the JAX package's gradient first
    jumps at update 20, where a ReLU input 3.3e-7 off zero in float64
    takes the other sign under the JAX learner's params and under the
    port's keeps it."""
    from tests._torch_c9_bisect import updates

    out = updates(24, seed=0)
    for row in out["rows"]:
        for side in ("jax", "port"):
            assert row[f"loss_{side}"] == pytest.approx(row["loss_f64"],
                                                        rel=1e-5)
        assert row["params_port"] <= 1e-6 and row["target_port"] <= 1e-6
    kink = out["kink"]
    assert kink["update"] == 20
    assert abs(kink["relu_input_f64"]) <= 1e-6
    assert kink["sign_flips_port"] == 0 and kink["sign_flips_jax"] >= 1
