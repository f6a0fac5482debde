"""The evolution-strategies suite: host-side numpy ask/tell optimizers
(counterpart: ``freerl_tpu/algos/es.py``).

``sepCEM`` (diagonal CEM with log-rank weights, damp decay tau 0.95,
antithetic sampling, optional elitism) and the variant set: ``VES``
(vanilla / OpenAI ES), ``GES`` (guided ES with a low-rank surrogate
subspace), ``sepCMAES`` (diagonal CMA-ES), ``sepCEMv2`` (importance
mixing), ``Control`` (no-op baseline), ``sepCEMA`` (mu / cov learning
rates) and ``sepMCEM`` (mirrored sampling).

These run on the host, once per generation, in float64 numpy, as the JAX
package's do; the port keeps its own copy. Where the JAX package draws
from the global ``np.random``, each class here draws from the
``np.random.RandomState`` it is given (``rng``; a fresh unseeded one by
default). ``RandomState(s)`` gives the stream ``np.random.seed(s)`` does,
so under the same seed ``ask`` and ``tell`` here are bit-equal to the JAX
package's.
"""
from __future__ import annotations

import numpy as np


class ESBase:
    def __init__(self, num_params, mu_init=None, sigma_init=1e-3,
                 pop_size=10, rng: np.random.RandomState | None = None):
        self.num_params = num_params
        self.mu = (
            np.zeros(num_params) if mu_init is None else np.array(mu_init)
        )
        self.sigma = sigma_init
        self.pop_size = pop_size
        self.rng = np.random.RandomState() if rng is None else rng

    def ask(self, pop_size):
        raise NotImplementedError

    def tell(self, solutions, scores):
        raise NotImplementedError

    def get_distrib_params(self):
        return np.copy(self.mu), self.sigma


def _log_rank_weights(parents):
    w = np.array([np.log((parents + 1) / i) for i in range(1, parents + 1)])
    return w / w.sum()


class sepCEM(ESBase):
    """Separable (diagonal-covariance) cross-entropy method."""

    def __init__(self, num_params, mu_init=None, sigma_init=1e-3,
                 pop_size=256, damp=1e-3, damp_limit=1e-5, parents=None,
                 elitism=False, antithetic=False, rng=None):
        super().__init__(num_params, mu_init, sigma_init, pop_size, rng)
        self.damp = damp
        self.damp_limit = damp_limit
        self.tau = 0.95
        self.cov = sigma_init * np.ones(num_params)
        self.elitism = elitism
        self.elite = np.sqrt(sigma_init) * self.rng.rand(num_params)
        self.elite_score = None
        self.antithetic = antithetic
        if antithetic:
            assert pop_size % 2 == 0, "Population size must be even"
        self.parents = parents if parents and parents > 0 else pop_size // 2
        self.weights = _log_rank_weights(self.parents)

    def ask(self, pop_size):
        if self.antithetic and not pop_size % 2:
            half = self.rng.randn(pop_size // 2, self.num_params)
            eps = np.concatenate([half, -half])
        else:
            eps = self.rng.randn(pop_size, self.num_params)
        inds = self.mu + eps * np.sqrt(self.cov)
        if self.elitism:
            inds[-1] = self.elite
        return inds

    def tell(self, solutions, scores):
        scores = -np.array(scores)          # maximize
        idx = np.argsort(scores)
        old_mu = self.mu
        self.damp = self.damp * self.tau + (1 - self.tau) * self.damp_limit
        top = solutions[idx[: self.parents]]
        self.mu = self.weights @ top
        z = top - old_mu
        # the reference's form: (1/parents) * weights @ z^2 + damp
        self.cov = (1.0 / self.parents) * (
            self.weights @ (z * z)
        ) + self.damp * np.ones(self.num_params)
        self.elite = solutions[idx[0]]
        self.elite_score = scores[idx[0]]

    def get_distrib_params(self):
        return np.copy(self.mu), np.copy(self.cov)


class VES(ESBase):
    """Vanilla / OpenAI ES: antithetic gradient estimate, plain step."""

    def __init__(self, num_params, mu_init=None, sigma_init=0.1,
                 pop_size=10, lr=1e-2, rng=None):
        super().__init__(num_params, mu_init, sigma_init, pop_size, rng)
        self.lr = lr
        self._eps = None

    def ask(self, pop_size):
        half = self.rng.randn(pop_size // 2, self.num_params)
        self._eps = np.concatenate([half, -half])
        return self.mu + self.sigma * self._eps

    def tell(self, solutions, scores):
        scores = np.array(scores)
        ranks = scores.argsort().argsort() / (len(scores) - 1) - 0.5
        grad = ranks @ self._eps / (len(scores) * self.sigma)
        self.mu = self.mu + self.lr * grad


class GES(ESBase):
    """Guided ES: half the noise lives in a surrogate-gradient subspace."""

    def __init__(self, num_params, mu_init=None, sigma_init=0.1,
                 pop_size=10, lr=1e-2, k=1, alpha=0.5, rng=None):
        super().__init__(num_params, mu_init, sigma_init, pop_size, rng)
        self.lr = lr
        self.alpha = alpha
        self.U = self.rng.randn(num_params, k) / np.sqrt(num_params)
        self._eps = None

    def add_surrogate(self, grad):
        self.U = grad.reshape(-1, 1) / (np.linalg.norm(grad) + 1e-8)

    def ask(self, pop_size):
        k = self.U.shape[1]
        full = self.rng.randn(pop_size // 2, self.num_params)
        sub = self.rng.randn(pop_size // 2, k) @ self.U.T
        half = (
            np.sqrt(self.alpha) * full
            + np.sqrt(1 - self.alpha) * sub * np.sqrt(self.num_params / k)
        )
        self._eps = np.concatenate([half, -half])
        return self.mu + self.sigma * self._eps

    def tell(self, solutions, scores):
        scores = np.array(scores)
        ranks = scores.argsort().argsort() / (len(scores) - 1) - 0.5
        grad = ranks @ self._eps / (len(scores) * self.sigma)
        self.mu = self.mu + self.lr * grad


class sepCMAES(ESBase):
    """Diagonal CMA-ES (rank-mu update with evolution paths)."""

    def __init__(self, num_params, mu_init=None, sigma_init=0.1,
                 pop_size=10, parents=None, rng=None):
        super().__init__(num_params, mu_init, sigma_init, pop_size, rng)
        self.parents = parents or pop_size // 2
        self.weights = _log_rank_weights(self.parents)
        self.mu_eff = 1.0 / np.sum(self.weights**2)
        n = num_params
        self.c_sigma = (self.mu_eff + 2) / (n + self.mu_eff + 5)
        self.d_sigma = (
            1 + 2 * max(0, np.sqrt((self.mu_eff - 1) / (n + 1)) - 1)
            + self.c_sigma
        )
        self.c_c = (4 + self.mu_eff / n) / (n + 4 + 2 * self.mu_eff / n)
        self.c_1 = 2 / ((n + 1.3) ** 2 + self.mu_eff)
        self.c_mu = min(
            1 - self.c_1,
            2 * (self.mu_eff - 2 + 1 / self.mu_eff)
            / ((n + 2) ** 2 + self.mu_eff),
        )
        self.p_sigma = np.zeros(n)
        self.p_c = np.zeros(n)
        self.C = np.ones(n)
        self.chi_n = np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n**2))

    def ask(self, pop_size):
        self._eps = self.rng.randn(pop_size, self.num_params)
        return self.mu + self.sigma * self._eps * np.sqrt(self.C)

    def tell(self, solutions, scores):
        scores = -np.array(scores)
        idx = np.argsort(scores)[: self.parents]
        old_mu = self.mu.copy()
        y = (solutions[idx] - old_mu) / self.sigma
        y_w = self.weights @ y
        self.mu = old_mu + self.sigma * y_w
        self.p_sigma = (1 - self.c_sigma) * self.p_sigma + np.sqrt(
            self.c_sigma * (2 - self.c_sigma) * self.mu_eff
        ) * y_w / np.sqrt(self.C)
        self.p_c = (1 - self.c_c) * self.p_c + np.sqrt(
            self.c_c * (2 - self.c_c) * self.mu_eff
        ) * y_w
        self.C = (
            (1 - self.c_1 - self.c_mu) * self.C
            + self.c_1 * self.p_c**2
            + self.c_mu * (self.weights @ (y**2))
        )
        self.sigma = self.sigma * np.exp(
            (self.c_sigma / self.d_sigma)
            * (np.linalg.norm(self.p_sigma) / self.chi_n - 1)
        )


class sepCEMv2(sepCEM):
    """CEM with importance mixing: reuse a fraction of the previous
    population when the distribution barely moved."""

    def __init__(self, *args, mix_ratio=0.2, **kwargs):
        super().__init__(*args, **kwargs)
        self.mix_ratio = mix_ratio
        self._prev = None

    def ask(self, pop_size):
        fresh = super().ask(pop_size)
        if self._prev is not None:
            n_keep = int(self.mix_ratio * pop_size)
            fresh[:n_keep] = self._prev[:n_keep]
        self._prev = fresh
        return fresh


class Control(ESBase):
    """No-op baseline: resamples around a fixed mean."""

    def ask(self, pop_size):
        return self.mu + self.sigma * self.rng.randn(
            pop_size, self.num_params
        )

    def tell(self, solutions, scores):
        pass


class sepCEMA(sepCEM):
    """CEM with learning rates on mu and cov (smoothed updates)."""

    def __init__(self, *args, mu_lr=0.7, cov_lr=0.3, **kwargs):
        super().__init__(*args, **kwargs)
        self.mu_lr = mu_lr
        self.cov_lr = cov_lr

    def tell(self, solutions, scores):
        old_mu, old_cov = np.copy(self.mu), np.copy(self.cov)
        super().tell(solutions, scores)
        self.mu = old_mu + self.mu_lr * (self.mu - old_mu)
        self.cov = old_cov + self.cov_lr * (self.cov - old_cov)


class sepMCEM(sepCEM):
    """CEM with forced mirrored sampling."""

    def __init__(self, *args, **kwargs):
        kwargs["antithetic"] = True
        if "pop_size" in kwargs and kwargs["pop_size"] % 2:
            kwargs["pop_size"] += 1
        super().__init__(*args, **kwargs)
