"""Action distributions as plain tensor functions (counterpart:
``freerl_tpu/nets/distributions.py``).

- categorical softmax policies, with the masked form (-1e8 invalid logits,
  masked entropy terms zeroed);
- the diagonal Gaussian with a state-independent ``log_std``;
- the tanh-squashed Gaussian with the stable softplus log-prob correction;
- the Beta policy, ``softplus(x) + 1`` parameterization.

Every sampling function but ``beta_sample`` takes its noise as an
argument: a standard normal ``eps``, or Gumbel noise for the categorical
(``jax.random.categorical`` is ``argmax(gumbel + logits)``), so a test can
feed in the JAX package's draws. ``draw_normal`` and ``draw_gumbel`` make
them from a ``torch.Generator``. ``beta_sample`` draws from the caller's
generator itself: its rejection sampler has no fixed number of draws to
inject.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LOG2 = math.log(2.0)


def draw_normal(shape, generator: torch.Generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device)


def draw_gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Gumbel noise -log(-log(U)), U uniform on [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


# ---------------------------------------------------------------------------
# Categorical
# ---------------------------------------------------------------------------
def categorical_sample(logits: torch.Tensor,
                       gumbel: torch.Tensor) -> torch.Tensor:
    """The Gumbel-max sample: ``argmax(gumbel + logits)``."""
    return torch.argmax(gumbel + logits, dim=-1)


def categorical_log_prob(logits: torch.Tensor,
                         action: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, action[..., None].to(torch.int64))[..., 0]


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def masked_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mask: 1 for valid actions. Invalid logits are pushed to -1e8."""
    return torch.where(mask > 0, logits, -1e8)


def masked_categorical_entropy(logits: torch.Tensor,
                               mask: torch.Tensor) -> torch.Tensor:
    """Entropy with the masked terms zeroed."""
    logp = F.log_softmax(masked_logits(logits, mask), dim=-1)
    terms = torch.where(mask > 0, torch.exp(logp) * logp, 0.0)
    return -torch.sum(terms, dim=-1)


# ---------------------------------------------------------------------------
# Diagonal Gaussian
# ---------------------------------------------------------------------------
def normal_sample(mean: torch.Tensor, std: torch.Tensor,
                  eps: torch.Tensor) -> torch.Tensor:
    return mean + std * eps


def normal_log_prob(mean: torch.Tensor, std: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    var = std ** 2
    return torch.sum(
        -0.5 * ((x - mean) ** 2 / var) - torch.log(std)
        - 0.5 * math.log(2 * math.pi),
        dim=-1,
    )


def normal_entropy(std: torch.Tensor) -> torch.Tensor:
    return torch.sum(0.5 + 0.5 * math.log(2 * math.pi) + torch.log(std),
                     dim=-1)


# ---------------------------------------------------------------------------
# Tanh-squashed Gaussian (SAC)
# ---------------------------------------------------------------------------
def squashed_sample_logp(mean: torch.Tensor, log_std: torch.Tensor,
                         eps: torch.Tensor, max_action: float = 1.0):
    """rsample -> tanh -> scale, and the log-prob with the stable softplus
    correction ``logp(a) = logp_normal(u) - sum_i 2*(log2 - u_i -
    softplus(-2 u_i))``."""
    std = torch.exp(log_std)
    u = mean + std * eps
    logp = torch.sum(
        -0.5 * ((u - mean) ** 2 / std ** 2) - log_std
        - 0.5 * math.log(2 * math.pi),
        dim=-1,
    )
    logp = logp - torch.sum(2.0 * (LOG2 - u - F.softplus(-2.0 * u)), dim=-1)
    return torch.tanh(u) * max_action, logp


def squashed_mode(mean: torch.Tensor, max_action: float = 1.0) -> torch.Tensor:
    return torch.tanh(mean) * max_action


# ---------------------------------------------------------------------------
# Beta (PPO trick)
# ---------------------------------------------------------------------------
def beta_params(raw_alpha: torch.Tensor, raw_beta: torch.Tensor):
    """softplus(x) + 1 parameterization (keeps the density unimodal)."""
    return F.softplus(raw_alpha) + 1.0, F.softplus(raw_beta) + 1.0


def _gamma_sample(shape_param: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """Gamma(shape, 1) by Marsaglia and Tsang's rejection sampler, from
    ``generator``; shapes below 1 are boosted by ``U ** (1 / shape)``. Each
    round redraws the rows not yet accepted (more than 95% accept per round
    for shapes >= 1)."""
    a = shape_param
    boost = a < 1.0
    d = torch.where(boost, a + 1.0, a) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while bool(todo.any()):
        x = torch.randn(a.shape, generator=generator, device=a.device)
        u = torch.rand(a.shape, generator=generator, device=a.device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = torch.rand(a.shape, generator=generator, device=a.device)
    return torch.where(boost, out * u ** (1.0 / a), out)


def beta_sample(alpha: torch.Tensor, beta: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """Beta(alpha, beta) as ``X / (X + Y)`` with X ~ Gamma(alpha) and
    Y ~ Gamma(beta), drawn from ``generator``."""
    alpha, beta = torch.broadcast_tensors(alpha, beta)
    x = _gamma_sample(alpha, generator)
    y = _gamma_sample(beta, generator)
    return x / (x + y)


def beta_log_prob(alpha: torch.Tensor, beta: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 1e-6, 1.0 - 1e-6)
    lb = torch.lgamma(alpha + beta) - torch.lgamma(alpha) - torch.lgamma(beta)
    return torch.sum(
        lb + (alpha - 1) * torch.log(x) + (beta - 1) * torch.log1p(-x), dim=-1
    )


def beta_entropy(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    lb = torch.lgamma(alpha) + torch.lgamma(beta) - torch.lgamma(alpha + beta)
    h = (
        lb
        - (alpha - 1) * torch.digamma(alpha)
        - (beta - 1) * torch.digamma(beta)
        + (alpha + beta - 2) * torch.digamma(alpha + beta)
    )
    return torch.sum(h, dim=-1)


def beta_mean(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    return alpha / (alpha + beta)


def beta_to_action(x: torch.Tensor, max_action: float) -> torch.Tensor:
    """Map the Beta support [0, 1] to the env box [-max, max]."""
    return (2.0 * x - 1.0) * max_action


def action_to_beta(a: torch.Tensor, max_action: float) -> torch.Tensor:
    return (a / max_action + 1.0) / 2.0
