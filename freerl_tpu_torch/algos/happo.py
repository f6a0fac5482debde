"""HAPPO: heterogeneous-agent trust-region PPO with the sequential
importance-factor chain (counterpart: ``freerl_tpu/algos/happo.py``).

MAPPO's joint GAE and centralized critics, but the agents update one
after another, in an order drawn anew for each update; a compound
``factor`` (B,), starting at ones, multiplies each agent's clipped
surrogate and is multiplied after that agent's K epochs by
``exp(new_logp - old_logp)`` over the whole batch. Actor and critic have
separate Adams, at ``actor_lr`` and ``critic_lr`` (neither decays: the
JAX update reads no episode count), and each net's gradients are clipped
at 0.5 on every minibatch.

Order is the result. The JAX update carries ONE key from position to
position: the agent at position p draws its epochs' permutations from
what position p - 1 left, so the permutations belong to a position, not
to an agent. ``update`` takes a :class:`HAPPODraws`: the order (A,) and
the permutations (A, K, B) indexed by position; the order runs as a host
loop (one host read of the order per update).
"""
from __future__ import annotations

import dataclasses

import torch

from freerl_tpu_torch.algos.common import clip_grads_by_norm, gae, huber
from freerl_tpu_torch.algos.mappo import (MAPPO, MAPPOConfig, MAPPOState,
                                          step)
from freerl_tpu_torch.algos.ppo import Rollout
from freerl_tpu_torch.distributed.dp import pmean


@dataclasses.dataclass(frozen=True)
class HAPPOConfig(MAPPOConfig):
    actor_lr: float = 1e-4
    critic_lr: float = 1e-4


@dataclasses.dataclass
class HAPPOState(MAPPOState):
    """MAPPO's state with one Adam per actor and one per critic
    (``actor_opts``, ``critic_opts``) in place of the joint ones."""

    actor_opts: list = dataclasses.field(default_factory=list)
    critic_opts: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class HAPPODraws:
    order: torch.Tensor      # (A,) the agents in update order
    perms: torch.Tensor      # (A, K, B): position p's epoch permutations


class HAPPO(MAPPO):
    def __init__(self, env, cfg: HAPPOConfig = None, device="cuda"):
        super().__init__(env, cfg or HAPPOConfig(), device)
        # the agents update one by one, each with its own Adams
        self._stackable = False

    def init(self, generator: torch.Generator) -> HAPPOState:
        actors, critics = self._nets(generator)
        cfg = self.cfg
        eps = 1e-5 if cfg.adam_eps else 1e-8

        def adam(net, lr):
            return torch.optim.Adam(net.parameters(), lr=lr, eps=eps,
                                    weight_decay=0.0)

        return HAPPOState(
            actors=actors, critics=critics, opts=[], **self._stats(),
            actor_opts=[adam(a, cfg.actor_lr) for a in actors],
            critic_opts=[adam(c, cfg.critic_lr) for c in critics])

    def draw_update(self, rollout: Rollout, generator: torch.Generator):
        """The update order and each position's K epochs' permutations."""
        order = torch.randperm(self.n_agents, generator=generator,
                               device=self.device)
        return HAPPODraws(order=order,
                          perms=super().draw_update(rollout, generator))

    def _full_logp(self, state, i, obs_f, act_i):
        aobs = self._actor_obs(obs_f, i)
        return self._logp_ent(state.actors[i](aobs), aobs, act_i)[0]

    def update(self, state: HAPPOState, rollout: Rollout, draws: HAPPODraws,
               episodes=None):
        """One full update, in place: GAE, then the agents in
        ``draws.order``, the one at position p for K epochs in the orders
        ``draws.perms[p]``. Returns (state, {"adv_mean", "factor_mean"})."""
        cfg = self.cfg
        if draws is None:
            raise ValueError("HAPPO's update needs its order and "
                             "permutations")
        a = self.n_agents
        T, N = rollout.reward.shape[:2]
        B = T * N
        mb = min(cfg.minibatch_size, B)
        with torch.no_grad():
            adv, v_target = gae(
                rollout.reward, self._values(state, rollout.obs),
                self._values(state, rollout.next_obs),
                rollout.done[..., None], rollout.adv_done[..., None],
                cfg.gamma, cfg.lmbda)
            if cfg.adv_norm:
                adv = (adv - torch.mean(adv)) / (
                    torch.std(adv, correction=0) + 1e-8)
            obs_f = rollout.obs.reshape((B, a, -1))
            act_f = rollout.action.reshape(
                (B, a, -1) if self.is_continue else (B, a))
            logp_old_f = rollout.log_pi.reshape((B, a))
            adv_f, vt_f = adv.reshape((B, a)), v_target.reshape((B, a))
        factor = torch.ones(B, device=adv_f.device)

        for pos, i in enumerate(draws.order.tolist()):
            act_i = (act_f[:, i, :self.act_dims[i]] if self.is_continue
                     else act_f[:, i])
            actor, critic = state.actors[i], state.critics[i]
            a_params, c_params = (list(actor.parameters()),
                                  list(critic.parameters()))
            with torch.no_grad():
                old_logp = self._full_logp(state, i, obs_f, act_i)
            for perm in draws.perms[pos]:
                for m in range(B // mb):
                    idx = perm[m * mb:(m + 1) * mb]
                    obs = obs_f[idx]
                    aobs = self._actor_obs(obs, i)
                    logp, ent = self._logp_ent(actor(aobs), aobs, act_i[idx])
                    ratio = torch.exp(logp - logp_old_f[idx, i])[:, None]
                    surr1 = ratio * adv_f[idx]
                    surr2 = torch.clamp(ratio, 1 - cfg.clip_param,
                                        1 + cfg.clip_param) * adv_f[idx]
                    actor_loss = -torch.mean(
                        factor[idx][:, None] * torch.minimum(surr1, surr2)
                    ) - cfg.entropy_coefficient * torch.mean(ent)
                    v = critic(self._critic_input(obs, i))[:, None]
                    err = vt_f[idx] - v
                    critic_loss = torch.mean(
                        huber(err, cfg.huber_delta) if cfg.huber_loss
                        else torch.square(err))
                    # both nets' gradients averaged in one all-reduce
                    g = pmean([*torch.autograd.grad(actor_loss, a_params),
                               *torch.autograd.grad(critic_loss, c_params)],
                              cfg.axis_name)
                    a_g, c_g = g[:len(a_params)], g[len(a_params):]
                    step(state.actor_opts[i], a_params,
                         clip_grads_by_norm(a_g, 0.5))
                    step(state.critic_opts[i], c_params,
                         clip_grads_by_norm(c_g, 0.5))
            with torch.no_grad():
                factor = factor * torch.exp(
                    self._full_logp(state, i, obs_f, act_i) - old_logp)

        state.step += 1
        return state, {"adv_mean": torch.mean(adv_f),
                       "factor_mean": torch.mean(factor)}
