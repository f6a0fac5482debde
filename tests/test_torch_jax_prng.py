"""The port's copy of ``jax.random`` (``freerl_tpu_torch/core/jax_prng.py``)
against ``jax.random``, and the fixed-reset start it gives every env of the
port's registry against the JAX package's ``FixedResetWrapper``.

Keys, splits, uniforms and randints are bit-equal over 1,000 seeds at every
shape and range a reset draws. Each env's ``key_reset_draw`` is bit-equal
to the draw its JAX counterpart makes in ``reset(key)``; the start
observation the port's ``FixedResetWrapper`` pins lies within one float32
ulp of the JAX package's eager reset (the two compute cos, sin and the
physics from the same draw with their own float32 kernels; the JAX
package's own jitted reset parts from its eager one by up to 2 ulps, where
XLA fuses LunarLander's velocity scaling).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.envs import make as jax_make
from freerl_tpu.envs.base import FixedResetWrapper as JaxFixedReset
from freerl_tpu_torch.core import jax_prng
from freerl_tpu_torch.envs import _REGISTRY, make
from freerl_tpu_torch.envs.base import Env, FixedResetWrapper

torch.set_num_threads(1)

N_SEEDS = 1000
# the seeds of the parity rows: 0, 10, 100, then 1-13
START_SEEDS = (0, 10, 100) + tuple(range(1, 14))
ENVS = sorted(_REGISTRY)


def _reset_ranges() -> list:
    """(shape, minval, maxval) of every uniform a registered env's reset
    draws."""
    out = [((4,), -0.05, 0.05), ((), -0.6, -0.4), ((), -np.pi, np.pi),
           ((), -1.0, 1.0), ((2,), -1000.0, 1000.0), ((5, 2), -1e-3, 1e-3),
           ((), 0.0, 1.0)]
    for name in ENVS:
        env = make(name, device="cpu")
        if hasattr(env, "n_landmarks"):
            out += [((env.n_agents, 2), -1, 1),
                    ((env.n_landmarks, 2), -0.9, 0.9)]
    return list(dict.fromkeys(out))


def _randint_spans() -> list:
    """Every (minval, maxval) a registered env's reset draws an int in."""
    spans = {(0, 2)}
    for name in ENVS:
        env = make(name, device="cpu")
        if hasattr(env, "start_states"):
            spans.add((0, len(env.start_states)))
    return sorted(spans)


@pytest.fixture(scope="module")
def keys():
    ks = jax.vmap(jax.random.PRNGKey)(jnp.arange(N_SEEDS))
    return np.asarray(ks), [jax_prng.prng_key(s) for s in range(N_SEEDS)]


def test_threefry_partitionable_is_the_installed_default():
    """The copy targets JAX's defaults: threefry2x32 keys with
    ``jax_threefry_partitionable`` on (off, seed 0's Pendulum start is
    theta 0.359, not 2.151)."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


def test_prng_key_and_split_bit_equal(keys):
    jkeys, pkeys = keys
    assert np.array_equal(jkeys, np.stack(pkeys))
    for num in (2, 3):
        want = np.asarray(jax.vmap(lambda k: jax.random.split(k, num))(
            jnp.asarray(jkeys)))
        got = np.stack([jax_prng.split(k, num) for k in pkeys])
        assert got.dtype == np.uint32 and np.array_equal(got, want)
    assert np.array_equal(jax_prng.prng_key(2 ** 40 + 7),
                          np.array([2 ** 8, 7], np.uint32))


@pytest.mark.parametrize("shape,lo,hi", _reset_ranges())
def test_uniform_bit_equal(keys, shape, lo, hi):
    jkeys, pkeys = keys
    want = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.uniform(
        k, shape, jnp.float32, lo, hi)))(jnp.asarray(jkeys)))
    got = np.stack([jax_prng.uniform(k, shape, lo, hi) for k in pkeys])
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_needs_one_rounding(keys):
    """The scale and shift round once, as XLA's fused multiply-add does:
    computed as two float32 operations, a share of Pendulum's theta draws
    is one ulp off."""
    jkeys, pkeys = keys
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (), jnp.float32, -jnp.pi, jnp.pi))(jnp.asarray(jkeys)))
    lo, hi = np.float32(-np.pi), np.float32(np.pi)
    two = []
    for k in pkeys:
        bits = jax_prng.random_bits(k, (1,))
        f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
            np.float32) - np.float32(1.0)
        two.append(np.maximum(lo, f * (hi - lo) + lo)[0])
    assert np.mean(np.asarray(two, np.float32) != want) > 0.2


@pytest.mark.parametrize("lo,hi", _randint_spans())
def test_randint_bit_equal(keys, lo, hi):
    jkeys, pkeys = keys
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(
        k, (), lo, hi))(jnp.asarray(jkeys)))
    got = np.stack([jax_prng.randint(k, (), lo, hi) for k in pkeys])
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


def jax_reset_draw(name: str, key) -> np.ndarray:
    """The draw the JAX package's env ``name`` makes in ``reset(key)``, laid
    out as the port's ``draw_reset`` lays out one row."""
    u = lambda k, shape, lo, hi: np.asarray(  # noqa: E731
        jax.random.uniform(k, shape, jnp.float32, lo, hi))
    if name in ("CartPole-v1", "PixelCartPole-v1"):
        return u(key, (4,), -0.05, 0.05)
    if name.startswith("MountainCar"):
        return u(key, (), -0.6, -0.4)
    if name == "Pendulum-v1":
        k1, k2 = jax.random.split(key)
        return np.stack([u(k1, (), -jnp.pi, jnp.pi), u(k2, (), -1.0, 1.0)])
    if name == "GoalPendulum-v1":
        k_in, k_goal = jax.random.split(key)
        return np.concatenate([jax_reset_draw("Pendulum-v1", k_in)] + [
            u(g, (1,), 0.0, 1.0) for g in jax.random.split(k_goal)])
    if name.startswith("LunarLander"):
        k1, _ = jax.random.split(key)
        return u(k1, (2,), -1000.0, 1000.0)
    if name == "BipedalWalker-v3":
        k, k_n = jax.random.split(key)
        us = []
        for _ in range(200):
            k, kr = jax.random.split(k)
            us.append(u(kr, (), -1.0, 1.0))
        return np.concatenate([np.stack(us),
                               u(k_n, (5, 2), -1e-3, 1e-3).reshape(-1)])
    if name in ("FrozenLake-v1", "Taxi-v3"):
        n = len(jax_make(name).start_states)
        return np.asarray(jax.random.randint(key, (), 0, n))
    if name == "deep-sea-treasure-v0":
        return np.zeros((), np.int32)
    jenv = jax_make(name)
    goal = name == "simple_adversary_v3"
    ks = jax.random.split(key, 3 if goal else 2)
    apos = u(ks[0], (jenv.n_agents, 2), -1, 1)
    lpos = u(ks[1], (jenv.n_entities - jenv.n_agents, 2), -0.9, 0.9)
    g = float(jax.random.randint(ks[2], (), 0, 2)) if goal else 0.0
    return np.concatenate([apos.reshape(-1), lpos.reshape(-1),
                           np.array([g], np.float32)])


def within_one_ulp(a, b) -> bool:
    """Whether every element of two float32 arrays lies within one float32
    ulp of the other's."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ulp = np.maximum(np.spacing(np.abs(a)), np.spacing(np.abs(b)))
    return bool(np.all(np.abs(a.astype(np.float64) - b.astype(np.float64))
                       <= ulp.astype(np.float64)))


def start_pair(name: str, seed: int):
    """(the JAX package's fixed-reset start observation, the port's on the
    CPU, the port's pinned draw) for ``seed``."""
    jenv = JaxFixedReset(jax_make(name), seed)
    _, jobs = jenv.reset(jax.random.PRNGKey(12345))
    port = FixedResetWrapper(make(name, device="cpu"), seed)
    other = port.draw_reset(3, torch.Generator().manual_seed(seed + 1))
    _, obs = port.reset(other)
    assert torch.equal(obs[0], obs[2])             # every reset is pinned
    return np.asarray(jobs), obs[0].numpy(), port._reset_draw


@pytest.mark.parametrize("name", ENVS)
def test_key_reset_draw_is_the_jax_draw(name):
    """For every registered env and the parity seeds, the draw the port
    pins is the JAX env's own draw, bit for bit, in the port's layout and
    dtype, and the start observation lies within one float32 ulp of the
    JAX package's."""
    env = make(name, device="cpu")
    layout = env.draw_reset(2, torch.Generator().manual_seed(0))
    for seed in START_SEEDS:
        key = jax.random.PRNGKey(seed)
        draw = env.key_reset_draw(jax_prng.prng_key(seed))
        assert draw.shape == (1,) + layout.shape[1:]
        assert draw.dtype == layout.dtype
        want = jax_reset_draw(name, key).reshape(draw.shape[1:])
        got = draw[0].numpy()
        assert got.tobytes() == want.astype(got.dtype).tobytes(), seed
        assert np.array_equal(got, want), seed
        jobs, obs, pinned = start_pair(name, seed)
        assert torch.equal(pinned, draw)
        assert obs.size == jobs.size
        assert within_one_ulp(obs.reshape(-1), jobs.reshape(-1)), (seed,
                                                                   obs, jobs)


def test_wrappers_forward_the_key_draw_and_a_bare_env_raises():
    """``DisToConWrapper`` forwards ``key_reset_draw``; an env without it
    stops the wrapper at construction: there is no fallback to a torch
    draw."""
    inner = make("Pendulum-v1", device="cpu")
    dis = FixedResetWrapper(make("Pendulum-v1", dis_to_con=True,
                                 device="cpu"), 7)
    assert torch.equal(dis._reset_draw, FixedResetWrapper(inner, 7)._reset_draw)

    class Bare(Env):
        dim_info = inner.dim_info

        def draw_reset(self, n, generator):
            return torch.zeros(n)

    with pytest.raises(NotImplementedError, match="key_reset_draw"):
        FixedResetWrapper(Bare(device="cpu"), 0)


def test_the_pinned_draw_is_made_once_on_the_host():
    """The wrapper reads no torch generator: building it leaves the global
    stream where it was, and two wrappers of one seed pin one draw."""
    state = torch.get_rng_state()
    a = FixedResetWrapper(make("LunarLander-v2", device="cpu"), 3)
    assert torch.equal(torch.get_rng_state(), state)
    b = FixedResetWrapper(make("LunarLander-v2", device="cpu"), 3)
    assert torch.equal(a._reset_draw, b._reset_draw)
