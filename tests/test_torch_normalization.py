"""The port's normalizers (``core/normalization.py``) and action
distributions (``nets/distributions.py``) against the JAX package, on
numpy-seeded inputs.

Tolerances: rtol 1e-5 / atol 1e-6 for the running statistics and every
deterministic function (float32 rounding of means, logs and special
functions; atol 1e-5 where lgamma/digamma of values up to ~20 enter);
sampling with fed-in draws is compared the same way, the categorical
sample exactly. ``beta_sample`` draws from the caller's generator and is
held statistically: its mean and variance against the Beta's, within 3%
and 6% at 40,000 draws, and its deciles against ``jax.random.beta``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.core import normalization as jnorm
from freerl_tpu.nets import distributions as jdist
from freerl_tpu_torch.core.normalization import (PopArt, RewardScaling,
                                                 RunningMeanStd)
from freerl_tpu_torch.nets import distributions as dist

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


# --------------------------------------------------------------------------
@pytest.mark.parametrize("lead", [(8,), (2, 4)], ids=["batch", "nested"])
def test_running_mean_std_matches_jax(lead):
    rng = np.random.RandomState(0)
    j = jnorm.RunningMeanStd.create((3,))
    p = RunningMeanStd.create((3,), device="cpu")
    for step in range(4):
        x = (rng.randn(*lead, 3) * (step + 1) + step).astype(np.float32)
        j, p = j.update(jnp.asarray(x)), p.update(torch.from_numpy(x))
        for k in ("mean", "var", "count"):
            close(getattr(p, k), getattr(j, k))
    y = (rng.randn(5, 3) * 10).astype(np.float32)
    close(p.normalize(t(y)), j.normalize(jnp.asarray(y)))
    close(p.normalize(t(y), clip=1.5), j.normalize(jnp.asarray(y), clip=1.5))
    close(p.denormalize(t(y)), j.denormalize(jnp.asarray(y)))


def test_running_mean_std_is_population_variance():
    """One batch into fresh stats: var = (1e-4 * 1 + n * var0(x) + ...)/tot
    with the population (not the unbiased) variance of x."""
    x = torch.tensor([[1.0], [3.0]])
    rms = RunningMeanStd.create((1,), device="cpu").update(x)
    tot = 2 + 1e-4
    want = (1e-4 * 1.0 + 2 * 1.0 + 4.0 * 1e-4 * 2 / tot) / tot
    np.testing.assert_allclose(float(rms.var[0]), want, rtol=1e-6)


def test_axis_name_raises():
    """An axis no ``make_mesh`` registered raises, naming it."""
    with pytest.raises(LookupError, match="'data'.*make_mesh"):
        RunningMeanStd.create((3,), "cpu").update(torch.zeros(2, 3), "data")


def test_reward_scaling_matches_jax():
    rng = np.random.RandomState(1)
    j = jnorm.RewardScaling.create(6, 0.99)
    p = RewardScaling.create(6, 0.99, device="cpu")
    for step in range(6):
        r = (rng.randn(6) * 5).astype(np.float32)
        done = rng.rand(6) < 0.3
        j, js = j(jnp.asarray(r), jnp.asarray(done))
        p, ps = p(torch.from_numpy(r), torch.from_numpy(done))
        close(ps, js)
        close(p.ret, j.ret)
        close(p.stats.var, j.stats.var)


def test_popart_matches_jax():
    rng = np.random.RandomState(2)
    j, p = jnorm.PopArt.create(()), PopArt.create((), device="cpu")
    for step in range(4):
        x = (rng.randn(32) * 20 + 50 * step).astype(np.float32)
        j, js, jb = j.adapt(jnp.asarray(x))
        p, ps, pb = p.adapt(torch.from_numpy(x))
        close(ps, js)
        close(pb, jb)
        for k in ("mean", "var", "count", "std"):
            close(getattr(p, k), getattr(j, k))
    y = rng.randn(16).astype(np.float32)
    close(p.normalize(t(y)), j.normalize(jnp.asarray(y)))
    close(p.denormalize(t(y)), j.denormalize(jnp.asarray(y)))


def test_popart_preserves_outputs():
    """A head rescaled by (scale, shift) gives, denormalized with the new
    stats, what it gave with the old ones."""
    rng = np.random.RandomState(3)
    w, b = torch.randn(1, 8), torch.randn(1)
    h = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    old = PopArt.create((), device="cpu")
    before = old.denormalize((h @ w.T + b)[:, 0])
    new, scale, shift = old.adapt(torch.from_numpy(
        (rng.randn(64) * 30 + 7).astype(np.float32)))
    after = new.denormalize((h @ (w * scale).T + (b * scale + shift))[:, 0])
    np.testing.assert_allclose(after.numpy(), before.numpy(), rtol=1e-5,
                               atol=1e-4)


# --------------------------------------------------------------------------
def test_categorical_matches_jax():
    rng = np.random.RandomState(4)
    logits = (rng.randn(64, 5) * 2).astype(np.float32)
    key = jax.random.PRNGKey(0)
    want = jdist.categorical_sample(key, jnp.asarray(logits))
    g = t(jax.random.gumbel(key, (64, 5)))
    np.testing.assert_array_equal(
        dist.categorical_sample(t(logits), g).numpy(), np.asarray(want))
    a = rng.randint(0, 5, 64)
    close(dist.categorical_log_prob(t(logits), t(a)),
          jdist.categorical_log_prob(jnp.asarray(logits), jnp.asarray(a)))
    close(dist.categorical_entropy(t(logits)),
          jdist.categorical_entropy(jnp.asarray(logits)))
    mask = (rng.rand(64, 5) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    close(dist.masked_logits(t(logits), t(mask)),
          jdist.masked_logits(jnp.asarray(logits), jnp.asarray(mask)))
    close(dist.masked_categorical_entropy(t(logits), t(mask)),
          jdist.masked_categorical_entropy(jnp.asarray(logits),
                                           jnp.asarray(mask)))


def test_gaussians_match_jax():
    rng = np.random.RandomState(5)
    mean = rng.randn(32, 3).astype(np.float32)
    log_std = np.clip(rng.randn(32, 3), -3, 1).astype(np.float32)
    std = np.exp(log_std).astype(np.float32)
    key = jax.random.PRNGKey(1)
    eps = t(jax.random.normal(key, (32, 3)))
    close(dist.normal_sample(t(mean), t(std), eps),
          jdist.normal_sample(key, jnp.asarray(mean), jnp.asarray(std)))
    x = rng.randn(32, 3).astype(np.float32)
    close(dist.normal_log_prob(t(mean), t(std), t(x)),
          jdist.normal_log_prob(jnp.asarray(mean), jnp.asarray(std),
                                jnp.asarray(x)), rtol=1e-5, atol=1e-5)
    close(dist.normal_entropy(t(std)), jdist.normal_entropy(jnp.asarray(std)))
    a, logp = dist.squashed_sample_logp(t(mean), t(log_std), eps, 2.0)
    ja, jlogp = jdist.squashed_sample_logp(key, jnp.asarray(mean),
                                           jnp.asarray(log_std), 2.0)
    close(a, ja)
    close(logp, jlogp, rtol=1e-5, atol=1e-5)
    close(dist.squashed_mode(t(mean), 2.0),
          jdist.squashed_mode(jnp.asarray(mean), 2.0))


def test_beta_functions_match_jax():
    rng = np.random.RandomState(6)
    ra, rb = (rng.randn(2, 32, 2) * 3).astype(np.float32)
    a, b = dist.beta_params(t(ra), t(rb))
    ja, jb = jdist.beta_params(jnp.asarray(ra), jnp.asarray(rb))
    close(a, ja)
    close(b, jb)
    x = rng.rand(32, 2).astype(np.float32)
    x[0] = [0.0, 1.0]                                  # the clip's edges
    close(dist.beta_log_prob(a, b, t(x)),
          jdist.beta_log_prob(ja, jb, jnp.asarray(x)), rtol=1e-5, atol=1e-5)
    close(dist.beta_entropy(a, b), jdist.beta_entropy(ja, jb), rtol=1e-5,
          atol=1e-5)
    close(dist.beta_mean(a, b), jdist.beta_mean(ja, jb))
    act = dist.beta_to_action(t(x), 2.0)
    close(act, jdist.beta_to_action(jnp.asarray(x), 2.0))
    close(dist.action_to_beta(act, 2.0), x, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ab", [(1.0, 1.0), (2.5, 7.0), (12.0, 3.0),
                                (0.5, 0.8)], ids=str)
def test_beta_sample_statistics(ab):
    n = 40_000
    alpha, beta = ab
    g = torch.Generator().manual_seed(0)
    x = dist.beta_sample(torch.full((n,), alpha), torch.tensor(beta), g)
    assert x.shape == (n,) and bool(((x >= 0) & (x <= 1)).all())
    mean = alpha / (alpha + beta)
    var = alpha * beta / ((alpha + beta) ** 2 * (alpha + beta + 1))
    np.testing.assert_allclose(float(x.mean()), mean, rtol=0.03)
    np.testing.assert_allclose(float(x.var()), var, rtol=0.06)
    jx = np.asarray(jax.random.beta(jax.random.PRNGKey(0), alpha, beta, (n,)))
    deciles = np.linspace(0.1, 0.9, 9)
    np.testing.assert_allclose(np.quantile(x.numpy(), deciles),
                               np.quantile(jx, deciles), atol=0.015)
    again = dist.beta_sample(torch.full((n,), alpha), torch.tensor(beta),
                             torch.Generator().manual_seed(0))
    assert torch.equal(x, again)


def test_draws_are_standard():
    g = torch.Generator().manual_seed(0)
    z = dist.draw_normal((50_000,), g, "cpu")
    np.testing.assert_allclose([float(z.mean()), float(z.std())], [0, 1],
                               atol=0.02)
    gum = dist.draw_gumbel((50_000,), g, "cpu")
    # Gumbel(0, 1): mean Euler's gamma, variance pi^2 / 6
    np.testing.assert_allclose([float(gum.mean()), float(gum.var())],
                               [0.5772157, np.pi ** 2 / 6], rtol=0.03)
