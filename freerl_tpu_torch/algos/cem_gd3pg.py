"""CEM-GD3PG: the evolutionary and gradient hybrid, a guided dual-actor
DDPG (counterpart: ``freerl_tpu/algos/cem_gd3pg.py``).

- a ``sepCEM`` population over FLAT actor parameter vectors;
- two gradient actors f1 / f2 with an EMA of their fitness (alpha 0.2);
  the domain actor copies the stronger one, and the weaker one is pulled
  toward the domain policy with ``lambda * delta * RMS action gap``, where
  ``delta = 1 - f_weak / f_strong`` clipped at 1;
- the best ES member mixes into the weaker actor (half and half) on each
  ES tell / ask cycle;
- two replay buffers (population rollouts, domain rollouts); a learner
  step samples half its batch from each;
- one critic, bootstrapped from the min over the two actor targets'
  values; each net clipped at norm 0.5 (optax's ``clip_by_global_norm``,
  no epsilon), Adam eps 1e-8.

**The flat vector** is the JAX package's ``ravel_pytree`` order, so an ES
population moves between the two packages unchanged: the layers in the
lexicographic order of their flax names (``Dense_0``, ``Dense_1``, ...),
each its bias, then its kernel ``(in, out)`` row-major (the transpose of
the torch weight).

**Population rollouts** run the P candidates (or the fused episode's four
lanes) as one batched product per layer, each candidate driving its own
env row, and score each by its FIRST episode's return.

**Host logic**, as the JAX ``train_cem_gd3pg`` has it: the fitness EMAs ``f1_total`` and
``f2_total`` are host float32 (the JAX state stores them as
``jnp.float32`` every episode; a float64 EMA could flip ``is_f1_more`` on a
near-tie), the guidance branch and ``delta`` are host values, and the
fused episode reads one flag per chunk to stop early.

Every draw is an argument: ``eval_population`` and the fused episode take
their env and noise draws, ``learn_burst`` its replay indices, all made by
a :class:`CEMDraws` from a ``torch.Generator``; the ES draws from its
``np.random.RandomState``.

**The learner burst on the card** is one learner step captured in a CUDA
graph and replayed once per index row, PyTorch's counterpart of the JAX
package's ``fori_loop`` under ``jit``: the row's indices go in through
static device buffers and each actor's guidance factor through a device
scalar filled once a burst, one graph for each branch of ``is_f1_more``.
On the card the optimizers are Adam with ``capturable=True``, on the
graph and the eager path alike, so the graph replays the eager step's own
kernels (``learn_burst(..., graph=False)`` is its twin); the CPU runs the
eager loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from freerl_tpu_torch.algos.base import frozen_copy
from freerl_tpu_torch.algos.common import optimizer_step, polyak
from freerl_tpu_torch.algos.ddpg import QCritic, TanhActor
from freerl_tpu_torch.algos.es import sepCEM
from freerl_tpu_torch.buffers.uniform import ReplayBuffer
from freerl_tpu_torch.core.types import DimInfo, Transition
from freerl_tpu_torch.envs.base import Env, step_auto_reset


@dataclasses.dataclass(frozen=True)
class CEMGD3PGConfig:
    """The JAX package's fields and defaults but two it never reads:
    ``beta_mix`` (the elite mixes in at a fixed half) and ``axis_name``
    (the hybrid has no data-parallel path)."""

    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.01
    batch_size: int = 64
    buffer_size: int = 200_000
    hidden: Sequence[int] = (128, 128)
    lambda_: float = 10.0           # guidance weight
    alpha: float = 0.2              # fitness EMA
    pop_size: int = 10
    sigma_init: float = 1e-3
    damp: float = 1e-3
    damp_limit: float = 1e-5
    elitism: bool = False
    gauss_sigma: float = 0.1
    sigma_decay: float = 0.999
    sigma_min: float = 0.05


@dataclasses.dataclass
class CEMGD3PGState:
    actor1: TanhActor
    actor2: TanhActor
    actor1_target: TanhActor
    actor2_target: TanhActor
    domain: TanhActor
    critic: QCritic
    critic_target: QCritic
    actor1_opt: torch.optim.Adam
    actor2_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    f1_total: np.float32 = np.float32(0.0)
    f2_total: np.float32 = np.float32(0.0)
    step: int = 0


@dataclasses.dataclass
class RolloutAcc:
    """A batched rollout's running totals: each row's first-episode
    return and length, whether its first episode has ended, and the last
    stretch's transitions, (T, rows, ...)."""

    ret: torch.Tensor
    ep_len: torch.Tensor
    done_once: torch.Tensor
    trans: Optional[Transition] = None


def _layers(actor: TanhActor) -> list:
    return [*actor.hidden, actor.head]


def _flat_order(n: int) -> list[int]:
    """The layers' positions in ``ravel_pytree`` order: by flax name."""
    return sorted(range(n), key=lambda i: f"Dense_{i}")


class CEMGD3PG:
    def __init__(self, dim_info: DimInfo,
                 cfg: CEMGD3PGConfig = CEMGD3PGConfig(), device="cuda"):
        if not dim_info.is_continue:
            raise ValueError("CEM-GD3PG is continuous-action")
        self.dim_info = dim_info
        self.cfg = cfg
        self.device = torch.device(device)
        dims = [dim_info.obs_dim, *cfg.hidden, dim_info.action_dim]
        # (in, out) per layer, in network order
        self.shapes = list(zip(dims[:-1], dims[1:]))
        self.num_params = sum(i * o + o for i, o in self.shapes)

    # ------------------------------------------------------------------
    def _actor(self, generator):
        di = self.dim_info
        return TanhActor(di.obs_dim, di.action_dim, tuple(self.cfg.hidden),
                         di.max_action, "torch", generator, self.device)

    def init(self, generator: torch.Generator) -> CEMGD3PGState:
        cfg, di = self.cfg, self.dim_info
        a1, a2 = self._actor(generator), self._actor(generator)
        critic = QCritic(di.obs_dim, di.action_dim, tuple(cfg.hidden),
                         "torch", generator, self.device)

        def adam(net, lr):
            # capturable on the card: the step count lives on the device,
            # so the learner step can be replayed from a CUDA graph
            return torch.optim.Adam(net.parameters(), lr=lr, eps=1e-8,
                                    capturable=self.device.type == "cuda")

        return CEMGD3PGState(
            actor1=a1, actor2=a2, actor1_target=frozen_copy(a1),
            actor2_target=frozen_copy(a2), domain=frozen_copy(a1),
            critic=critic, critic_target=frozen_copy(critic),
            actor1_opt=adam(a1, cfg.actor_lr),
            actor2_opt=adam(a2, cfg.actor_lr),
            critic_opt=adam(critic, cfg.critic_lr))

    # -- the flat vector -------------------------------------------------
    def flat(self, actor: TanhActor) -> torch.Tensor:
        """The actor's parameters as one flat device vector, in the JAX
        package's ``ravel_pytree`` order."""
        layers = _layers(actor)
        return torch.cat([t.detach().reshape(-1)
                          for i in _flat_order(len(layers))
                          for t in (layers[i].bias, layers[i].weight.T)])

    def get_params(self, actor: TanhActor) -> np.ndarray:
        return self.flat(actor).cpu().numpy()

    def unflatten(self, flat: torch.Tensor) -> list:
        """(..., num_params) flat vectors -> per layer in network order,
        (bias (..., out), kernel (..., in, out))."""
        out, off = [None] * len(self.shapes), 0
        for i in _flat_order(len(self.shapes)):
            n_in, n_out = self.shapes[i]
            bias = flat[..., off:off + n_out]
            off += n_out
            kernel = flat[..., off:off + n_in * n_out].reshape(
                flat.shape[:-1] + (n_in, n_out))
            off += n_in * n_out
            out[i] = (bias, kernel)
        return out

    @torch.no_grad()
    def set_params(self, actor: TanhActor, flat) -> TanhActor:
        """Write a flat vector (numpy or tensor) into ``actor``, in place;
        its optimizer state is kept, as the JAX state keeps it."""
        flat = torch.as_tensor(np.asarray(flat, np.float32),
                               device=self.device)
        for layer, (bias, kernel) in zip(_layers(actor),
                                         self.unflatten(flat)):
            layer.bias.copy_(bias)
            layer.weight.copy_(kernel.T)
        return actor

    def stacked_policy(self, flat: torch.Tensor, obs: torch.Tensor):
        """Actions of P actors given as flat vectors (P, num_params), one
        observation each (P, obs): one batched product per layer."""
        layers = self.unflatten(flat)
        x = obs[:, None, :]
        for i, (bias, kernel) in enumerate(layers):
            x = torch.baddbmm(bias[:, None, :], x, kernel)
            if i < len(layers) - 1:
                x = F.relu(x)
        return torch.tanh(x[:, 0]) * self.dim_info.max_action

    # ------------------------------------------------------------------
    @torch.no_grad()
    def select_action(self, actor: TanhActor, obs: torch.Tensor):
        return actor(obs)

    @torch.no_grad()
    def rollout(self, env: Env, flat: torch.Tensor, draws: "RolloutDraws",
                sigma: Optional[torch.Tensor] = None, carry=None):
        """Step ``flat``'s P actors, each on its own env row, for the steps
        of ``draws``: from a reset, or from ``carry``, the (env state, obs,
        ``RolloutAcc``) a previous call returned. ``sigma`` (P,) scales
        Gaussian action noise, as a fraction of ``max_action``. Returns
        the new carry."""
        ma = self.dim_info.max_action
        if carry is None:
            env_state, obs = env.reset(draws.reset)
            zeros = torch.zeros(flat.shape[0], device=self.device)
            acc = RolloutAcc(zeros, zeros.to(torch.int32), zeros.bool())
        else:
            env_state, obs, acc = carry
        steps = []
        for t in range(len(draws.step_reset)):
            a = self.stacked_policy(flat, obs)
            if sigma is not None:
                a = torch.clamp(a + sigma[:, None] * ma * draws.normal[t],
                                -ma, ma)
            out = step_auto_reset(env, env_state, a, draws.step[t],
                                  draws.step_reset[t])
            live = ~acc.done_once
            acc.ret = acc.ret + out.reward * live
            acc.ep_len = acc.ep_len + live.to(torch.int32)
            acc.done_once = acc.done_once | out.episode_done
            steps.append(Transition(obs=obs, action=a, reward=out.reward,
                                    next_obs=out.next_obs,
                                    done=out.terminated,
                                    episode_done=out.episode_done))
            env_state, obs = out.state, out.carry_obs
        acc.trans = Transition(**{
            f.name: torch.stack([getattr(s, f.name) for s in steps])
            for f in dataclasses.fields(Transition)})
        return env_state, obs, acc

    def eval_population(self, env: Env, flat_params, draws: "RolloutDraws"):
        """Fitness of P candidate actors, each driving its own env row for
        ``len(draws.step)`` steps: (fitness (P,) device, transitions
        (T, P, ...))."""
        flat = torch.as_tensor(np.asarray(flat_params, np.float32),
                               device=self.device)
        acc = self.rollout(env, flat, draws)[2]
        return acc.ret, acc.trans

    # ------------------------------------------------------------------
    def factors(self, is_f1_more: bool, delta: float) -> tuple:
        """Each actor's weight on its guidance term, as float32 values:
        ``lambda * delta`` for the weaker actor (actor1 when f2 is the
        stronger), 0 for the stronger."""
        delta = np.float32(delta)
        return tuple(float(np.float32(guided * self.cfg.lambda_) * delta)
                     for guided in ((0.0, 1.0) if is_f1_more else (1.0, 0.0)))

    def learn(self, state: CEMGD3PGState, batch: Transition,
              is_f1_more: bool, delta: float):
        """One gradient step, in place: the critic, then both actors (the
        weaker one guided toward the domain policy), then the three
        targets. Returns (state, metrics)."""
        closs = self._learn_step(state, batch,
                                 self.factors(is_f1_more, delta))
        state.step += 1
        return state, {"critic_loss": closs.detach()}

    def _learn_step(self, state: CEMGD3PGState, batch: Transition,
                    factors: tuple) -> torch.Tensor:
        """``learn``'s step with the actors' guidance weights ``factors``
        (floats, or device scalars under a CUDA graph). Returns the critic
        loss."""
        cfg = self.cfg
        reward = batch.reward.reshape(-1)
        done = batch.done.reshape(-1).to(torch.float32)
        action = batch.action.reshape(-1, self.dim_info.action_dim)

        with torch.no_grad():
            q1 = state.critic_target(batch.next_obs,
                                     state.actor1_target(batch.next_obs))
            q2 = state.critic_target(batch.next_obs,
                                     state.actor2_target(batch.next_obs))
            target = reward + cfg.gamma * torch.minimum(q1, q2) * (1.0 - done)
            domain_a = state.domain(batch.obs)

        critic_params = list(state.critic.parameters())
        closs = torch.mean(torch.square(state.critic(batch.obs, action)
                                        - target))
        optimizer_step(state.critic_opt, critic_params, closs, 0.5)

        for actor, opt, factor in ((state.actor1, state.actor1_opt,
                                    factors[0]),
                                   (state.actor2, state.actor2_opt,
                                    factors[1])):
            a = actor(batch.obs)
            q = torch.mean(state.critic(batch.obs, a))
            gap = a - domain_a
            # eps keeps the sqrt's gradient finite where the actor IS the
            # domain policy
            kl = torch.sqrt(torch.sum(gap * gap) / gap.shape[0] + 1e-8)
            loss = -q + factor * kl
            optimizer_step(opt, list(actor.parameters()), loss, 0.5)

        polyak(state.actor1_target.parameters(), state.actor1.parameters(),
               cfg.tau)
        polyak(state.actor2_target.parameters(), state.actor2.parameters(),
               cfg.tau)
        polyak(state.critic_target.parameters(), critic_params, cfg.tau)
        return closs

    def learn_burst(self, state: CEMGD3PGState, buffer: ReplayBuffer,
                    buffer_domain: ReplayBuffer, idx: tuple, is_f1_more,
                    delta, graph: Optional[bool] = None):
        """``len(idx[0])`` learner steps; step i's batch is rows
        ``idx[0][i]`` of ``buffer`` then rows ``idx[1][i]`` of
        ``buffer_domain``. On the card (``graph`` None or True) the steps
        replay a CUDA graph of one step (:class:`BurstGraph`);
        ``graph=False``, and the CPU, run them one by one."""
        if graph is None:
            graph = self.device.type == "cuda"
        if graph:
            if self.device.type != "cuda":
                raise ValueError("learn_burst: a CUDA graph needs the card")
            runner = self.__dict__.get("_burst_graph")
            if runner is None:
                runner = self._burst_graph = BurstGraph(self)
            return runner.run(state, buffer, buffer_domain, idx, is_f1_more,
                              delta)
        for i1, i2 in zip(*idx):
            state, _ = self.learn(state, burst_batch(buffer, buffer_domain,
                                                     i1, i2),
                                  is_f1_more, delta)
        return state


def burst_batch(buffer: ReplayBuffer, buffer_domain: ReplayBuffer,
                i1: torch.Tensor, i2: torch.Tensor) -> Transition:
    """A learner step's batch: rows ``i1`` of ``buffer``, then rows ``i2``
    of ``buffer_domain``."""
    b1, b2 = buffer.gather(i1), buffer_domain.gather(i2)
    return Transition(**{
        f.name: torch.cat([getattr(b1, f.name), getattr(b2, f.name)])
        for f in dataclasses.fields(Transition)})


class BurstGraph:
    """CEM-GD3PG's learner step as a CUDA graph, one for each branch of
    ``is_f1_more``, replayed once per index row of a burst.

    The graph reads a row's indices from two static ``(half_b,)`` device
    buffers and the actors' guidance weights from two device scalars
    (``factors``, filled once a burst with the eager step's float32
    values), and it reads and writes the state's nets, optimizer states
    and the replay rings at the addresses they had when it was captured.
    So a graph is kept only while those addresses hold (``_addresses``):
    a new state, a ring that was reallocated or an optimizer whose state
    was replaced is captured again, never read through a stale address.
    A capture runs ``WARMUP`` real steps eagerly on a side stream first
    (the optimizers' state and the libraries' handles are made there, as
    CUDA graphs require); a burst too short for them runs them all so."""

    WARMUP = 3

    def __init__(self, algo: CEMGD3PG):
        self.algo = algo
        self.graphs: dict = {}          # is_f1_more -> (addresses, graph)
        self.idx = None                  # static (half_b,) index buffers
        self.factors = None              # static guidance weights

    @staticmethod
    def _addresses(state, buffer, buffer_domain) -> tuple:
        nets = (state.actor1, state.actor2, state.actor1_target,
                state.actor2_target, state.domain, state.critic,
                state.critic_target)
        opts = (state.actor1_opt, state.actor2_opt, state.critic_opt)
        rings = [getattr(b.data, f.name) for b in (buffer, buffer_domain)
                 for f in dataclasses.fields(Transition)]
        return tuple(t.data_ptr() for t in [
            *(p for net in nets for p in net.parameters()),
            *(v for opt in opts for st in opt.state.values()
              for v in st.values() if torch.is_tensor(v)), *rings])

    def _step(self, state, buffer, buffer_domain) -> None:
        self.algo._learn_step(
            state, burst_batch(buffer, buffer_domain, *self.idx),
            self.factors)

    def run(self, state, buffer, buffer_domain, idx, is_f1_more, delta):
        i1s, i2s = idx
        n = len(i1s)
        if n == 0:
            return state
        dev = self.algo.device
        if self.idx is None or self.idx[0].shape != i1s.shape[1:]:
            self.idx = (torch.zeros(i1s.shape[1:], dtype=torch.int64,
                                    device=dev),
                        torch.zeros(i2s.shape[1:], dtype=torch.int64,
                                    device=dev))
            self.factors = (torch.zeros((), device=dev),
                            torch.zeros((), device=dev))
            self.graphs.clear()
        for f, v in zip(self.factors, self.algo.factors(is_f1_more, delta)):
            f.fill_(v)
        addresses = self._addresses(state, buffer, buffer_domain)
        kept = self.graphs.get(is_f1_more)
        graph = kept[1] if kept is not None and kept[0] == addresses else None
        start = 0
        if graph is None:
            start = min(self.WARMUP, n)
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for r in range(start):
                    self.idx[0].copy_(i1s[r])
                    self.idx[1].copy_(i2s[r])
                    self._step(state, buffer, buffer_domain)
            torch.cuda.current_stream(dev).wait_stream(side)
            if start < n:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    self._step(state, buffer, buffer_domain)
                # the optimizers' state exists now: the addresses are final
                self.graphs[is_f1_more] = (
                    self._addresses(state, buffer, buffer_domain), graph)
        for r in range(start, n):
            self.idx[0].copy_(i1s[r])
            self.idx[1].copy_(i2s[r])
            graph.replay()
        state.step += n
        return state


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RolloutDraws:
    """The draws of a batched rollout over ``T`` steps of ``rows`` env
    rows: the reset draw (None when continuing a rollout), each step's env
    draw and auto-reset draw, and each step's (rows, A) action-noise
    normals (None without noise)."""

    reset: Optional[torch.Tensor]
    step: list
    step_reset: list
    normal: Optional[torch.Tensor] = None


class CEMDraws:
    """Every draw ``train_cem_gd3pg`` makes, from one generator. A test
    hands ``train_cem_gd3pg`` a subclass that returns the JAX package's
    draws."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def rollout(self, env: Env, rows: int, steps: int, reset: bool = True,
                noise: bool = False) -> RolloutDraws:
        g = self.generator
        return RolloutDraws(
            reset=env.draw_reset(rows, g) if reset else None,
            step=[env.draw_step(rows, g) for _ in range(steps)],
            step_reset=[env.draw_reset(rows, g) for _ in range(steps)],
            normal=torch.randn((steps, rows, env.dim_info.action_dim),
                               generator=g, device=env.device)
            if noise else None)

    def population(self, env: Env, P: int, T: int) -> RolloutDraws:
        return self.rollout(env, P, T)

    def chunk(self, env: Env, first: bool, steps: int) -> RolloutDraws:
        """A chunk of the fused 4-lane episode (the first one resets)."""
        return self.rollout(env, 4, steps, reset=first, noise=True)

    def burst(self, n_upd: int, half_b: int, size: int, size_domain: int):
        """Replay indices of ``n_upd`` learner steps: (n_upd, half_b) into
        each buffer."""
        def idx(n):
            return torch.randint(0, max(n, 1), (n_upd, half_b),
                                 generator=self.generator,
                                 device=self.generator.device)
        return idx(size), idx(size_domain)


def fitness_step(cfg: CEMGD3PGConfig, f1_total, f2_total, f1: float,
                 f2: float):
    """One episode's host logic: the fitness EMAs, in float64 from the
    float32 totals as the JAX ``train_cem_gd3pg`` has it, the guidance branch and the
    reference's ``delta`` (the ratio gap clipped at 1; where the stronger
    EMA is not positive the ratio flips, both being negative). Returns
    (f1_total, f2_total, is_f1_more, delta), the totals rounded to float32
    as the JAX state stores them."""
    f1_total = (1 - cfg.alpha) * float(f1_total) + cfg.alpha * f1
    f2_total = (1 - cfg.alpha) * float(f2_total) + cfg.alpha * f2
    is_f1_more = f1_total >= f2_total
    if is_f1_more:
        if f1_total > 0:
            delta = min(1.0, 1 - f2_total / f1_total)
        else:
            delta = 1 - f1_total / f2_total if f2_total != 0 else 1.0
    else:
        if f2_total > 0:
            delta = min(1.0, 1 - f1_total / f2_total)
        else:
            delta = 1 - f2_total / f1_total if f1_total != 0 else 1.0
    return np.float32(f1_total), np.float32(f2_total), is_f1_more, delta


def train_cem_gd3pg(env: Env, algo: CEMGD3PG, max_episodes: int = 200,
                    seed: int = 0, start_steps: int = 1000,
                    updates_per_episode: Optional[int] = None,
                    full_ratio: bool = False, on_episode=None,
                    draws: Optional[CEMDraws] = None):
    """The reference's ES / gradient interleave with batched population
    evaluation. Returns (state, returns, info).

    ``full_ratio=True`` keeps the reference's cadence (one learner step per
    domain-episode env step); the default caps a burst at 100 learner
    steps. Per episode: one fused 4-lane rollout (lanes 0 / 1 the clean
    evaluations of f1 / f2, lanes 2 / 3 noisy domain rollouts of both, the
    chosen one kept), in early-exit chunks; every ``pop_size`` episodes an
    ES tell / ask and a population evaluation. ``draws`` defaults to a
    :class:`CEMDraws` on a generator seeded with ``seed``; the ES draws
    from ``np.random.RandomState(seed)``."""
    cfg, device = algo.cfg, algo.device
    if draws is None:
        draws = CEMDraws(torch.Generator(device=device).manual_seed(seed))
    state = algo.init(draws.generator)
    di = env.dim_info
    example = Transition(
        obs=torch.zeros(di.obs_dim, device=device),
        action=torch.zeros(di.action_dim, device=device),
        reward=torch.zeros((), device=device),
        next_obs=torch.zeros(di.obs_dim, device=device),
        done=torch.zeros((), dtype=torch.bool, device=device),
        episode_done=torch.zeros((), dtype=torch.bool, device=device),
    )
    buffer = ReplayBuffer.create(cfg.buffer_size, example)
    buffer_domain = ReplayBuffer.create(cfg.buffer_size, example)

    def flatten_steps(trans):
        return trans.map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])))

    es = sepCEM(
        algo.num_params, mu_init=algo.get_params(state.actor1),
        sigma_init=cfg.sigma_init, damp=cfg.damp,
        damp_limit=cfg.damp_limit, pop_size=cfg.pop_size,
        antithetic=not cfg.pop_size % 2, parents=cfg.pop_size // 2,
        elitism=cfg.elitism, rng=np.random.RandomState(seed),
    )
    P, T = cfg.pop_size, env.max_steps
    es_params = es.ask(P * 2)
    fitness_arr, trans = algo.eval_population(
        env, es_params[:P], draws.population(env, P, T))
    fitness = list(fitness_arr.cpu().numpy())
    buffer.add(flatten_steps(trans))
    half_b = cfg.batch_size // 2

    gauss_sigma = cfg.gauss_sigma
    returns = []
    cnt_es = 0
    t0 = time.time()
    total_steps = int(trans.reward.numel())
    # early-exit chunks of the fused episode
    CH = T // 10 if T % 10 == 0 and T > 256 else T
    n_chunks = T // CH

    def fused_episode(sigma):
        flat4 = torch.stack([algo.flat(state.actor1),
                             algo.flat(state.actor2)]).repeat(2, 1)
        sig4 = torch.tensor([0.0, 0.0, sigma, sigma], dtype=torch.float32,
                            device=device)
        carry, chunks = None, []
        for c in range(n_chunks):
            carry = algo.rollout(env, flat4, draws.chunk(env, c == 0, CH),
                                 sig4, carry)
            acc = carry[2]
            chunks.append(acc.trans.map(lambda x: x[:, 2:]))
            if bool(acc.done_once.all()):   # one host read per chunk
                break
        return acc, chunks

    for ep in range(max_episodes):
        if cnt_es == P:
            es.tell(es_params, fitness)
            half = es.ask(P)
            fit_arr, trans = algo.eval_population(
                env, half, draws.population(env, P, T))
            fitness = list(fit_arr.cpu().numpy())
            buffer.add(flatten_steps(trans))
            total_steps += int(trans.reward.numel())
            cnt_es = 0
            best = int(np.argmax(fitness))
            if float(state.f1_total) >= float(state.f2_total):
                mixed = (half[best] + algo.get_params(state.actor2)) / 2
                algo.set_params(state.actor2, mixed)
            else:
                mixed = (half[best] + algo.get_params(state.actor1)) / 2
                algo.set_params(state.actor1, mixed)
            es_params[:P] = half

        acc, dom_chunks = fused_episode(gauss_sigma)
        ret4_h = acc.ret.cpu().numpy()
        ep_len4_h = acc.ep_len.cpu().numpy()
        f1, f2 = float(ret4_h[0]), float(ret4_h[1])
        state.f1_total, state.f2_total, is_f1_more, delta = fitness_step(
            cfg, state.f1_total, state.f2_total, f1, f2)
        domain = state.actor1 if is_f1_more else state.actor2
        state.domain.load_state_dict(domain.state_dict())
        es_params[cnt_es + P] = algo.get_params(domain)
        fitness.append(max(f1, f2))
        cnt_es += 1

        # the chosen domain lane -> the domain buffer. The chunks cover
        # whole CH-step windows (auto-reset rolls into later episodes),
        # but the recorded return and the update count use the FIRST
        # episode only
        lane = 0 if is_f1_more else 1
        for chunk in dom_chunks:
            buffer_domain.add(chunk.map(lambda x: x[:, lane]))
        ep_ret = float(ret4_h[2 + lane])
        ep_len = int(ep_len4_h[2 + lane])
        n_steps = ep_len if full_ratio else len(dom_chunks) * CH
        total_steps += n_steps
        gauss_sigma = max(cfg.sigma_min, gauss_sigma * cfg.sigma_decay)
        returns.append(float(ep_ret))

        if total_steps > start_steps:
            n_upd = updates_per_episode or (
                n_steps if full_ratio else min(n_steps, 100))
            state = algo.learn_burst(
                state, buffer, buffer_domain,
                draws.burst(n_upd, half_b, buffer.size, buffer_domain.size),
                is_f1_more, delta)

        if on_episode is not None:
            on_episode(ep, returns, total_steps)

    info = {
        "elapsed_s": time.time() - t0,
        "episodes": len(returns),
        "env_steps": total_steps,
    }
    return state, np.asarray(returns), info

