"""The JAX package's random keys and draws, recomputed on the host in numpy.

``--fixed_reset`` pins every episode to the start that the JAX package's
``FixedResetWrapper`` draws: ``env.reset(jax.random.PRNGKey(seed))``. That
start is a fixed function of the env and the seed, and the JAX envs' resets
reach it through three primitives only: ``split``, ``uniform`` and
``randint``. ``evaluate`` plays the JAX package's held-out episodes, whose
step keys come from ``fold_in``, and the tabular envs' steps draw through
``gumbel`` (``jax.random.categorical``'s noise). This module is a copy of
their arithmetic, bit-equal to ``jax.random`` under JAX's defaults (the
``threefry2x32`` key, with ``jax_threefry_partitionable`` on), so the port
makes the same draws without JAX. It runs on the host, once per wrapper or
evaluation; nothing here is on a hot path.

A key is a ``(2,)`` uint32 array; ``split`` returns ``(n, 2)``. Every
function also takes a batch of keys, ``(..., 2)``, and then puts the
batch's axes in front of its result, as ``jax.vmap`` over the keys would.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds on two uint32 count arrays of one
    shape, under ``key`` (``(2,)``, or a batch ``(..., 2)``): returns the
    two hashed words, of the batch's shape followed by the counts'."""
    key = np.asarray(key, np.uint32)
    batch = key.shape[:-1]
    # 1-d count arrays (2-d under a batch): numpy wraps uint32 arrays
    # silently, where 0-d results would be scalars that warn on overflow
    k0 = key[..., 0].reshape(-1, 1)
    k1 = key[..., 1].reshape(-1, 1)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    shape = batch + np.shape(x0)
    x = [np.asarray(x0, np.uint32).reshape(1, -1) + ks[0],
         np.asarray(x1, np.uint32).reshape(1, -1) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0].reshape(shape), x[1].reshape(shape)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32-bit words."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed {seed} is not a 64-bit unsigned integer")
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _counts(shape) -> tuple:
    """The partitionable counters: a 64-bit iota over ``shape`` as its
    (high, low) words."""
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 2 ** 32:
        raise ValueError(f"shape {shape} holds 2**32 or more draws")
    lo = np.arange(n, dtype=np.uint32).reshape(shape)
    return np.zeros(shape, np.uint32), lo


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``(num, 2)`` keys."""
    b0, b1 = threefry2x32(key, *_counts((num,)))
    return np.stack([b0, b1], axis=-1)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the key hashed with the counts
    ``(0, data)``, ``data`` taken as a uint32. An array of ``data`` gives
    one key for each value, as ``fold_in`` mapped over it would."""
    lo = (np.asarray(data, np.int64) & 0xFFFFFFFF).astype(np.uint32)
    b0, b1 = threefry2x32(key, np.zeros_like(lo), lo)
    return np.stack([b0, b1], axis=-1)


def random_bits(key, shape=()) -> np.ndarray:
    """``jax.random.bits(key, shape)`` of 32 bits: the two hashed words of
    each counter, xor-ed."""
    b0, b1 = threefry2x32(key, *_counts(tuple(shape)))
    return b0 ^ b1


def _round_fma(product: np.ndarray, addend: np.float32) -> np.ndarray:
    """``product + addend`` rounded once to float32, as a fused
    multiply-add rounds it. ``product`` is float64 and exact (a float32
    times a float32); the sum is taken in float64 with its error (two-sum),
    and where that sum is a float32 tie the error breaks it."""
    a = np.float64(addend)
    s = product + a
    bp = s - a
    err = (product - bp) + (a - (s - bp))
    r = s.astype(np.float32)
    tie = (np.abs(r.astype(np.float64) - s) * 2.0
           == np.abs(np.spacing(r).astype(np.float64)))
    nudge = tie & (err != 0)
    if np.any(nudge):
        s = np.where(nudge, np.nextafter(s, np.copysign(np.inf, err)), s)
        r = s.astype(np.float32)
    return r


def uniform(key, shape=(), minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)``:
    the bits' top 23 as a mantissa of [1, 2), less 1, scaled by
    ``maxval - minval`` (in float32) and shifted by ``minval`` in one
    rounding (XLA fuses the two into a multiply-add), clipped below at
    ``minval``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = random_bits(key, shape)
    f = ((bits.reshape(-1) >> np.uint32(9))
         | np.uint32(0x3F800000)).view(np.float32)
    f = f - np.float32(1.0)
    span = np.float64(hi - lo)
    out = _round_fma(f.astype(np.float64) * span, lo)
    return np.maximum(lo, out).reshape(bits.shape)


def gumbel(key, shape=()) -> np.ndarray:
    """``jax.random.gumbel(key, shape, jnp.float32)`` in its default
    ("low") mode: ``-log(-log(u))`` of ``uniform(key, shape, tiny, 1)``.
    The uniform is bit-equal; the two logs are numpy's float32 ones, where
    XLA's own are not correctly rounded, so a value may lie a few float32
    ulps from JAX's (at most 4.8e-7 over 9,000 draws)."""
    tiny = np.finfo(np.float32).tiny
    u = uniform(key, shape, tiny, 1.0)
    return -np.log(-np.log(u))


def randint(key, shape=(), minval: int = 0, maxval: int = 1) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` as int32: two
    words a draw from a split key, reduced mod the span with
    ``2**32 mod span`` as the high word's multiplier (in uint32 arithmetic,
    as JAX reduces them)."""
    ks = split(key)
    high = random_bits(ks[..., 0, :], shape)
    out_shape = high.shape
    high = high.reshape(-1)
    low = random_bits(ks[..., 1, :], shape).reshape(-1)
    span = np.uint32(maxval - minval) if maxval > minval else np.uint32(1)
    mult = np.uint32(2 ** 16) % span
    mult = np.uint32((int(mult) * int(mult)) % int(span))
    with np.errstate(over="ignore"):
        off = ((high % span) * mult + low % span) % span
    return (np.int32(minval) + off.astype(np.int32)).reshape(out_shape)
