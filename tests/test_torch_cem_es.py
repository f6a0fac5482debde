"""The port's ES suite and CEM-GD3PG against the JAX package.

- the eight ES classes: ``ask`` and ``tell`` bit-equal under the same
  seed (the JAX classes draw from the global ``np.random``, the port's
  from ``np.random.RandomState(seed)``, the same stream);
- the flat parameter vector in ``ravel_pytree`` order (trap T4: by flax
  layer name, bias before the row-major (in, out) kernel), through
  ``convert.py``, at 3 and 11 layers (``Dense_10`` sorts before
  ``Dense_2``);
- the fitness EMAs round-tripped through float32 (trap T5), on a near-tie
  that a float64 EMA decides the other way;
- one ``learn`` step of each guidance branch, a population evaluation
  with the JAX draws, and the slice: ``train_cem_gd3pg`` for three
  episodes (an ES tell / ask cycle and the elite mixing included), every
  draw JAX's.

Tolerances: learner state within 1e-5 (float32 matmul and Adam rounding
in two frameworks); Pendulum returns within rtol 1e-5; the ES suite and
the flat vectors bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.algos import es as jax_es
from freerl_tpu.algos.cem_gd3pg import CEMGD3PG as JaxCEMGD3PG
from freerl_tpu.algos.cem_gd3pg import CEMGD3PGConfig as JaxCEMGD3PGConfig
from freerl_tpu.algos.cem_gd3pg import train_cem_gd3pg as jax_train
from freerl_tpu.core.types import DimInfo as JaxDimInfo
from freerl_tpu.envs import make as jax_make
from freerl_tpu_torch.algos import es
from freerl_tpu_torch.algos.cem_gd3pg import (CEMDraws, CEMGD3PG,
                                              CEMGD3PGConfig, RolloutDraws,
                                              fitness_step, train_cem_gd3pg)
from freerl_tpu_torch.convert import (cem_gd3pg_state_from_flax,
                                      flat_from_flax, net_params_from_flax)
from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.envs import make
from tests.test_torch_dqn import _flax_params, _jax_t, _torch_t

torch.set_num_threads(1)

ATOL = 1e-5
DI = dict(obs_dim=3, action_dim=1, is_continue=True, max_action=2.0)
HIDDEN = (16, 16)
NETS = ("actor1", "actor2", "actor1_target", "actor2_target", "domain",
        "critic", "critic_target")

ES = {
    "sepCEM": lambda m, d: m.sepCEM(d, sigma_init=1.0, pop_size=8,
                                    antithetic=True, damp=0.3,
                                    damp_limit=0.1, elitism=True),
    "sepCEMA": lambda m, d: m.sepCEMA(d, sigma_init=1.0, pop_size=8,
                                      damp=0.3, damp_limit=0.1),
    "sepMCEM": lambda m, d: m.sepMCEM(d, sigma_init=1.0, pop_size=7),
    "sepCEMv2": lambda m, d: m.sepCEMv2(d, sigma_init=1.0, pop_size=8),
    "sepCMAES": lambda m, d: m.sepCMAES(d, sigma_init=1.0, pop_size=8),
    "VES": lambda m, d: m.VES(d, sigma_init=0.5, pop_size=8, lr=0.5),
    "GES": lambda m, d: m.GES(d, sigma_init=0.5, pop_size=8, lr=0.5),
    "Control": lambda m, d: m.Control(d, sigma_init=0.1),
}


class _Seeded:
    """The port's ES module with every class given ``rng``."""

    def __init__(self, rng):
        self.rng = rng

    def __getattr__(self, name):
        cls = getattr(es, name)
        return lambda *a, **kw: cls(*a, rng=self.rng, **kw)


@pytest.mark.parametrize("name", list(ES))
def test_es_bit_equal_under_the_same_seed(name):
    d = 6
    np.random.seed(11)
    jes = ES[name](jax_es, d)
    pes = ES[name](_Seeded(np.random.RandomState(11)), d)
    for _ in range(5):
        want, got = jes.ask(8), pes.ask(8)
        assert want.tobytes() == got.tobytes()
        scores = -np.sum((want - 3.0) ** 2, axis=-1)
        jes.tell(want, scores)
        pes.tell(got, scores)
        for a, b in zip(jes.get_distrib_params(), pes.get_distrib_params()):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


# ---------------------------------------------------------------------------
def make_pair(hidden=HIDDEN, **extra):
    kw = dict(hidden=hidden, batch_size=16, **extra)
    jalgo = JaxCEMGD3PG(JaxDimInfo(**DI), JaxCEMGD3PGConfig(**kw))
    jstate = jalgo.init(jax.random.PRNGKey(0))
    algo = CEMGD3PG(DimInfo(**DI), CEMGD3PGConfig(**kw), device="cpu")
    state = algo.init(torch.Generator().manual_seed(0))
    cem_gd3pg_state_from_flax(state, jax.tree.map(np.asarray, jstate))
    return jalgo, jstate, algo, state


def assert_states_close(state, jstate, what=""):
    for name in NETS:
        want = net_params_from_flax(_flax_params(getattr(jstate, name)))
        got = getattr(state, name).state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=ATOL, err_msg=f"{what} {name}.{k}")


@pytest.mark.parametrize("hidden", [(16, 16), (3,) * 10],
                         ids=["3_layers", "11_layers"])
def test_flat_vector_is_ravel_pytree_order(hidden):
    """The port's ``get_params`` equals ``ravel_pytree`` of the same
    params and ``convert.flat_from_flax``; ``set_params`` inverts it."""
    jalgo, jstate, algo, state = make_pair(hidden)
    want = jalgo.get_params(jstate.actor1)
    assert want.shape == (algo.num_params,)
    assert want.tobytes() == flat_from_flax(
        _flax_params(jstate.actor1)).tobytes()
    assert algo.get_params(state.actor1).tobytes() == want.tobytes()
    moved = want * 1.5 - 0.25
    algo.set_params(state.actor2, moved)
    back = net_params_from_flax(_flax_params(jalgo.set_params(moved)))
    for k, v in state.actor2.state_dict().items():
        assert v.numpy().tobytes() == back[k].numpy().tobytes(), k
    obs = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    stacked = algo.stacked_policy(
        torch.from_numpy(np.stack([want, moved])),
        torch.from_numpy(np.stack([obs[0], obs[1]])))
    for row, flat in enumerate((want, moved)):
        ref = jalgo.select_action(jalgo.set_params(flat), obs[row])
        np.testing.assert_allclose(stacked[row].numpy(), np.asarray(ref),
                                   atol=1e-6)


def test_config_leaves_out_dead_fields():
    """The JAX config's ``beta_mix`` (the elite mixes in at a fixed half)
    and ``axis_name`` are read nowhere there; the port has neither."""
    assert hasattr(JaxCEMGD3PGConfig(), "beta_mix")
    for name in ("beta_mix", "axis_name"):
        assert not hasattr(CEMGD3PGConfig(), name)


def _jax_totals(f1_tot, f2_tot, f1, f2, alpha=0.2):
    """The JAX ``train_cem_gd3pg``'s EMA step (cem_gd3pg.py:436-455): float64 from the
    jnp.float32 totals, stored back as jnp.float32."""
    a = (1 - alpha) * float(f1_tot) + alpha * f1
    b = (1 - alpha) * float(f2_tot) + alpha * f2
    return jnp.float32(a), jnp.float32(b), a >= b


def test_fitness_ema_round_trips_float32():
    """Two episodes of returns on a near-tie: the float32 totals decide
    f2 stronger at the second, as the JAX ``train_cem_gd3pg`` does; a float64 EMA would
    decide f1."""
    cfg = CEMGD3PGConfig()
    f1s = (-704.7376098632812, -329.48974609375)
    f2s = (-704.7377319335938, -329.4896545410156)
    t1 = t2 = np.float32(0.0)
    j1 = j2 = jnp.float32(0.0)
    for f1, f2 in zip(f1s, f2s):
        t1, t2, more, delta = fitness_step(cfg, t1, t2, f1, f2)
        j1, j2, jmore = _jax_totals(j1, j2, f1, f2)
        assert isinstance(t1, np.float32) and more == jmore
        assert t1.tobytes() == np.asarray(j1).tobytes()
        assert t2.tobytes() == np.asarray(j2).tobytes()
    assert not more
    d1 = 0.8 * (0.2 * f1s[0]) + 0.2 * f1s[1]
    d2 = 0.8 * (0.2 * f2s[0]) + 0.2 * f2s[1]
    assert d1 >= d2                      # float64 would pick f1


@pytest.mark.parametrize("is_f1_more", [True, False], ids=["f1", "f2"])
def test_learn_matches_jax(is_f1_more):
    """Two learner steps per guidance branch, from the JAX state (the
    domain actor a scaled copy, so the guidance term is live)."""
    jalgo, jstate, algo, state = make_pair()
    dom = jalgo.set_params(jalgo.get_params(jstate.actor2) * 0.7)
    jstate = jstate.replace(domain=dom)
    state.domain.load_state_dict(net_params_from_flax(_flax_params(dom)))
    learn = jax.jit(jalgo.learn)
    for i in range(2):
        rng = np.random.RandomState(i)
        done = rng.rand(16) < 0.2
        b = dict(obs=rng.randn(16, 3).astype(np.float32),
                 action=rng.uniform(-2, 2, (16, 1)).astype(np.float32),
                 reward=rng.randn(16).astype(np.float32),
                 next_obs=rng.randn(16, 3).astype(np.float32),
                 done=done, episode_done=done)
        jstate, jm = learn(jstate, _jax_t(b), jnp.bool_(is_f1_more),
                           jnp.float32(0.37))
        state, m = algo.learn(state, _torch_t(b), is_f1_more, 0.37)
        np.testing.assert_allclose(float(m["critic_loss"]),
                                   float(jm["critic_loss"]), rtol=1e-5)
        assert_states_close(state, jstate, f"learn {i}")


def _pendulum_reset(k):
    k1, k2 = jax.random.split(k)
    return jnp.stack([jax.random.uniform(k1, (), jnp.float32, -jnp.pi, jnp.pi),
                      jax.random.uniform(k2, (), jnp.float32, -1.0, 1.0)])


def _t(x):
    return torch.from_numpy(np.array(x))


def _lane_resets(key, n):
    """The reset draws of ``step_auto_reset`` on n lanes keyed by
    ``split(key, n)``."""
    return _t(jax.vmap(lambda k: _pendulum_reset(jax.random.split(k)[1]))(
        jax.random.split(key, n)))


class JaxDraws(CEMDraws):
    """The draws the JAX ``train_cem_gd3pg(seed=seed)`` makes, in its key
    order, for the port's ``train_cem_gd3pg``."""

    def __init__(self, seed):
        super().__init__(torch.Generator().manual_seed(0))
        self.key = jax.random.split(jax.random.PRNGKey(seed))[1]

    def _split(self):
        k, self.key = jax.random.split(self.key)
        return k

    def population(self, env, P, T):
        k_eval = self._split()
        return population_draws(k_eval, P, T)

    def chunk(self, env, first, steps):
        reset = None
        if first:
            k0, self.ck = jax.random.split(self._split())
            reset = _t(jax.vmap(_pendulum_reset)(jax.random.split(k0, 4)))
        normal, step_reset = [], []
        for _ in range(steps):
            self.ck, kn, kt = jax.random.split(self.ck, 3)
            normal.append(_t(jax.random.normal(kn, (4, 1))))
            step_reset.append(_lane_resets(kt, 4))
        return RolloutDraws(reset, [None] * steps, step_reset,
                            torch.stack(normal))

    def burst(self, n_upd, half_b, size, size_domain):
        k = self._split()
        idx1, idx2 = [], []
        for _ in range(n_upd):
            k, k1, k2 = jax.random.split(k, 3)
            idx1.append(np.asarray(jax.random.randint(k1, (half_b,), 0, size)))
            idx2.append(np.asarray(jax.random.randint(k2, (half_b,), 0,
                                                      size_domain)))
        return (torch.from_numpy(np.stack(idx1)).long(),
                torch.from_numpy(np.stack(idx2)).long())


def population_draws(key, P, T):
    return RolloutDraws(
        _t(jax.vmap(_pendulum_reset)(jax.random.split(key, P))),
        [None] * T,
        [_lane_resets(jax.random.fold_in(key, t), P) for t in range(T)])


def test_eval_population_matches_jax():
    """Three candidates, 60 steps each on their own Pendulum row, with the
    JAX rollout's draws: fitness and transitions."""
    jalgo, jstate, algo, state = make_pair()
    env, jenv = make("Pendulum-v1", device="cpu"), jax_make("Pendulum-v1")
    base = jalgo.get_params(jstate.actor1).astype(np.float64)
    flat = np.stack([base, base * 0.5, base * -1.0])
    key = jax.random.PRNGKey(3)
    jfit, jtrans = jalgo.eval_population(jenv, flat, key, max_steps=60)
    fit, trans = algo.eval_population(env, flat, population_draws(key, 3, 60))
    np.testing.assert_allclose(fit.numpy(), np.asarray(jfit), rtol=1e-5)
    for name in ("obs", "action", "reward", "done"):
        np.testing.assert_allclose(getattr(trans, name).numpy(),
                                   np.asarray(getattr(jtrans, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_train_cem_gd3pg_slice_matches_jax():
    """Three episodes with pop 2 (the third starts with an ES tell / ask,
    a population evaluation and the elite mixed into the weaker actor),
    three learner steps after each, every draw JAX's: the returns, the
    float32 EMAs and every net."""
    seed, P = 5, 2
    kw = dict(hidden=HIDDEN, pop_size=P, buffer_size=5_000, batch_size=16)
    jenv, env = jax_make("Pendulum-v1"), make("Pendulum-v1", device="cpu")
    jalgo = JaxCEMGD3PG(jenv.dim_info, JaxCEMGD3PGConfig(**kw))
    jinit = jalgo.init(jax.random.split(jax.random.PRNGKey(seed))[0])

    class Seeded(CEMGD3PG):
        def init(self, generator):
            state = super().init(generator)
            cem_gd3pg_state_from_flax(state, jax.tree.map(np.asarray, jinit))
            return state

    steps = []
    np.random.seed(seed)
    jstate, jreturns, jinfo = jax_train(
        jenv, jalgo, max_episodes=3, seed=seed, start_steps=100,
        updates_per_episode=3)
    algo = Seeded(DimInfo(**DI), CEMGD3PGConfig(**kw), device="cpu")
    state, returns, info = train_cem_gd3pg(
        env, algo, max_episodes=3, seed=seed, start_steps=100,
        updates_per_episode=3, draws=JaxDraws(seed),
        on_episode=lambda ep, r, n: steps.append(n))
    assert info["env_steps"] == jinfo["env_steps"] == steps[-1]
    np.testing.assert_allclose(returns, jreturns, rtol=1e-5)
    for name in ("f1_total", "f2_total"):
        assert isinstance(getattr(state, name), np.float32)
        np.testing.assert_allclose(float(getattr(state, name)),
                                   float(getattr(jstate, name)), rtol=1e-5)
    assert state.step == int(jstate.step) == 9
    assert_states_close(state, jstate, "after 3 episodes")
