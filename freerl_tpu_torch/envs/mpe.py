"""The PettingZoo MPE scenarios, batched over envs (counterpart:
``freerl_tpu/envs/mpe.py``).

The world step, for every env of the batch at once: the force of the 5-way
action (``u = [a1 - a2, a3 - a4]`` times the agent's acceleration), soft
contact forces between collidable entities (force 100, a stable softplus
of the penetration with margin 1e-3), damping 0.25, an optional per-entity
speed cap, and semi-implicit integration with dt 0.1.

Scenarios: ``simple_spread_v3`` (N agents cover N landmarks),
``simple_adversary_v3`` (one adversary, N good agents, 2 landmarks, one
goal), ``simple_tag_v3`` (3 slow adversaries chase 1 fast good agent among
2 obstacles) and ``simple_world_comm_v3`` (a speaking leader, 3
adversaries, good agents, food, forests that conceal).

Observations are ``(B, A, O)``, each agent's zero-padded to the widest
(``agent_obs_dims`` has the true widths); actions are ``(B, A, act)`` in
the env box ``[0, 1]`` (``action_space_01``; ``agent_act_dims`` has the
true widths) or ``(B, A)`` indices {0 noop, 1 +x, 2 -x, 3 +y, 4 -y}.
Episodes never terminate; they truncate at 25 steps.

The reset draw is an argument: ``(n, 2E + 1)``, every entity's position
(agents U(-1, 1), landmarks U(-0.9, 0.9)) then the adversary scenario's
goal index. The step draws nothing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from freerl_tpu_torch.core import jax_prng
from freerl_tpu_torch.core.types import DimInfo
from freerl_tpu_torch.envs.base import Env

DT = 0.1
DAMPING = 0.25
CONTACT_FORCE = 100.0
CONTACT_MARGIN = 1e-3


@dataclasses.dataclass
class MPEState:
    pos: torch.Tensor     # (B, E, 2): agents, then landmarks
    vel: torch.Tensor     # (B, E, 2)
    goal: torch.Tensor    # (B,) int64: the adversary scenario's goal; else 0
    t: torch.Tensor       # (B,) int32


@dataclasses.dataclass
class WorldCommState(MPEState):
    comm: torch.Tensor    # (B, dim_c): the leader's broadcast channel


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise distances (..., n, m) between (..., n, 2) and (..., m, 2),
    with the JAX package's 1e-8 under the root."""
    return torch.sqrt(torch.sum((a[..., :, None, :] - b[..., None, :, :]) ** 2,
                                dim=-1) + 1e-8)


def _bound(x: torch.Tensor) -> torch.Tensor:
    """The boundary penalty on |coordinate| (the scenarios' bound())."""
    x = torch.abs(x)
    return torch.where(
        x < 0.9, 0.0,
        torch.where(x < 1.0, (x - 0.9) * 10.0,
                    torch.clamp(torch.exp(2 * x - 2), max=10.0)))


def _others(n: int) -> list[list[int]]:
    """For each agent i < n, the other agents in order."""
    return [[j for j in range(n) if j != i] for i in range(n)]


class MPEBase(Env):
    """The MPE world; a scenario sets the entity tables (agents first, then
    landmarks) and its rewards and observations."""

    max_steps = 25
    reward_threshold = None
    act_dim = 5
    action_space_01 = True     # the env box is [0, 1]; policies act in [-1, 1]
    continuous_actions = True
    state_cls = MPEState
    n_agents: int

    def _tables(self, sizes, movable, collide, accel, max_speed) -> None:
        dev = self.device
        self.sizes = torch.as_tensor(np.asarray(sizes, np.float32), device=dev)
        self.movable = torch.as_tensor(np.asarray(movable, np.float32),
                                       device=dev)
        collide = torch.as_tensor(np.asarray(collide, bool), device=dev)
        n = len(sizes)
        self.coll_mask = (collide[:, None] & collide[None, :]
                          & ~torch.eye(n, dtype=torch.bool, device=dev))
        self.accel = torch.as_tensor(np.asarray(accel, np.float32), device=dev)
        ms = torch.as_tensor(np.asarray(max_speed, np.float32), device=dev)
        self.speed_cap = torch.where(ms > 0, ms, torch.inf)
        self.dist_min = self.sizes[:, None] + self.sizes[None, :]

    @property
    def n_entities(self) -> int:
        return self.sizes.shape[0]

    @property
    def n_landmarks(self) -> int:
        return self.n_entities - self.n_agents

    # ---- reset ---------------------------------------------------------
    n_goals = 0     # the adversary scenario draws its goal among 2

    def draw_reset(self, n: int, generator: torch.Generator) -> torch.Tensor:
        dev = self.device
        apos = torch.rand((n, self.n_agents, 2), generator=generator,
                          device=dev) * 2.0 - 1.0
        lpos = torch.rand((n, self.n_landmarks, 2), generator=generator,
                          device=dev) * 1.8 - 0.9
        goal = (torch.randint(0, self.n_goals, (n, 1), generator=generator,
                              device=dev).to(torch.float32)
                if self.n_goals else torch.zeros((n, 1), device=dev))
        return torch.cat([apos.reshape(n, -1), lpos.reshape(n, -1), goal], 1)

    def key_reset_draw(self, key) -> torch.Tensor:
        """The JAX scenarios' ``_reset_world``: the key split in two (three
        where a goal is drawn), agents in +-1, landmarks in +-0.9."""
        keys = jax_prng.split(key, 3 if self.n_goals else 2)
        apos = jax_prng.uniform(keys[0], (self.n_agents, 2), -1.0, 1.0)
        lpos = jax_prng.uniform(keys[1], (self.n_landmarks, 2), -0.9, 0.9)
        goal = (jax_prng.randint(keys[2], (), 0, self.n_goals)
                if self.n_goals else 0)
        return self._host_draw(np.concatenate([
            apos.reshape(-1), lpos.reshape(-1),
            np.array([goal], np.float32)]))

    def draw_step(self, n: int, generator: torch.Generator):
        return None

    def key_step_draw(self, keys):
        return None

    def _initial(self, draw: torch.Tensor) -> dict:
        n, e = draw.shape[0], self.n_entities
        pos = draw[:, :2 * e].reshape(n, e, 2)
        return dict(pos=pos, vel=torch.zeros_like(pos),
                    goal=draw[:, 2 * e].to(torch.int64),
                    t=torch.zeros(n, dtype=torch.int32, device=draw.device))

    def reset(self, draw: torch.Tensor):
        state = self.state_cls(**self._initial(draw))
        return state, self.observation(state)

    # ---- step ----------------------------------------------------------
    def step(self, state: MPEState, actions: torch.Tensor, step_draw=None):
        """actions: (B, A, act) in [0, 1], or (B, A) indices."""
        if self.continuous_actions:
            a = torch.clamp(actions, 0.0, 1.0)
        else:
            a = F.one_hot(actions.to(torch.int64), 5).to(torch.float32)
        u = torch.stack([a[..., 1] - a[..., 2], a[..., 3] - a[..., 4]], -1)
        pos = state.pos
        b = pos.shape[0]
        forces = torch.cat([u * self.accel[:, None], pos.new_zeros(
            (b, self.n_landmarks, 2))], dim=1)

        # soft contact forces between collidable pairs; the stable softplus
        # keeps overlapping pairs finite
        delta = pos[:, :, None, :] - pos[:, None, :, :]          # (B, E, E, 2)
        dist = torch.sqrt(torch.sum(delta ** 2, dim=-1) + 1e-8)
        k = CONTACT_MARGIN
        penetration = F.softplus(-(dist - self.dist_min) / k) * k
        fmag = CONTACT_FORCE * penetration * self.coll_mask
        fdir = delta / dist[..., None]
        contact = torch.sum(fmag[..., None] * fdir, dim=2)        # (B, E, 2)
        forces = forces + contact * self.movable[:, None]

        # integrate (every entity's mass is 1)
        vel = state.vel * (1.0 - DAMPING) + forces * DT
        speed = torch.sqrt(torch.sum(vel ** 2, dim=-1) + 1e-12)
        scale = torch.clamp(self.speed_cap / speed, max=1.0)
        vel = vel * scale[..., None] * self.movable[:, None]
        pos = pos + vel * DT

        new = dataclasses.replace(state, pos=pos, vel=vel, t=state.t + 1)
        self._update_comm(new, a)
        rewards = self._rewards(new)
        terminated = torch.zeros(b, dtype=torch.bool, device=pos.device)
        truncated = new.t >= self.max_steps
        return new, self.observation(new), rewards, terminated, truncated

    def _update_comm(self, state, a: torch.Tensor) -> None:
        """The communication channel's step, in place (silent world)."""

    def _rewards(self, state) -> torch.Tensor:
        raise NotImplementedError

    def observation(self, state) -> torch.Tensor:
        raise NotImplementedError

    def _pad(self, obs: list[torch.Tensor]) -> torch.Tensor:
        """Per-agent (B, O_i) observations, zero-padded and stacked."""
        width = max(o.shape[-1] for o in obs)
        return torch.stack([F.pad(o, (0, width - o.shape[-1])) for o in obs],
                           dim=1)

    def _dim_info(self, obs_dims, act_dims) -> None:
        self.agent_obs_dims = tuple(obs_dims)
        self.agent_act_dims = tuple(act_dims)
        self.dim_info = DimInfo(obs_dim=max(obs_dims),
                                action_dim=max(act_dims),
                                is_continue=self.continuous_actions,
                                max_action=1.0)


# ---------------------------------------------------------------------------
class SimpleSpread(MPEBase):
    """N agents cover N landmarks. Reward: (1 - local_ratio) times minus
    the sum over landmarks of the nearest agent's distance, plus
    local_ratio times -1 per collision with another agent."""

    name = "simple_spread_v3"

    def __init__(self, N: int = 3, local_ratio: float = 0.5,
                 continuous_actions: bool = True, device="cuda"):
        super().__init__(device)
        self.continuous_actions = continuous_actions
        self.n_agents = N
        self.local_ratio = local_ratio
        self._tables(sizes=[0.15] * N + [0.05] * N,
                     movable=[1] * N + [0] * N,
                     collide=[True] * N + [False] * N,
                     accel=[5.0] * N, max_speed=[-1.0] * (2 * N))
        obs_dim = 4 + 2 * N + 2 * (N - 1) + 2 * (N - 1)   # + comm zeros
        self._dim_info((obs_dim,) * N, (self.act_dim,) * N)
        self.other_idx = torch.as_tensor(_others(N), device=self.device)
        self.not_self = ~torch.eye(N, dtype=torch.bool, device=self.device)

    def _rewards(self, state: MPEState) -> torch.Tensor:
        N = self.n_agents
        apos, lpos = state.pos[:, :N], state.pos[:, N:]
        d = _dist(lpos, apos)                                  # (B, L, N)
        global_rew = -torch.sum(torch.amin(d, dim=2), dim=1)
        colliding = (_dist(apos, apos) < 0.3) & self.not_self
        local = -torch.sum(colliding, dim=2).to(torch.float32)
        return (global_rew[:, None] * (1.0 - self.local_ratio)
                + local * self.local_ratio)

    def observation(self, state: MPEState) -> torch.Tensor:
        N = self.n_agents
        b = state.pos.shape[0]
        apos, avel = state.pos[:, :N], state.vel[:, :N]
        lpos = state.pos[:, N:]
        lm_rel = (lpos[:, None] - apos[:, :, None]).reshape(b, N, -1)
        other_rel = (apos[:, self.other_idx] - apos[:, :, None]).reshape(
            b, N, -1)
        comm = apos.new_zeros((b, N, 2 * (N - 1)))
        return torch.cat([avel, apos, lm_rel, other_rel, comm], dim=-1)


# ---------------------------------------------------------------------------
class SimpleAdversary(MPEBase):
    """Physical deception: the adversary (agent 0) and N good agents, 2
    landmarks, one of them the goal. No collisions; shaped distance
    rewards."""

    name = "simple_adversary_v3"
    n_goals = 2

    def __init__(self, N: int = 2, continuous_actions: bool = True,
                 device="cuda"):
        super().__init__(device)
        self.continuous_actions = continuous_actions
        self.n_good = N
        self.n_agents = N + 1        # the adversary first (PettingZoo order)
        na = self.n_agents
        self._tables(sizes=[0.15] * na + [0.08] * 2,
                     movable=[1] * na + [0] * 2, collide=[False] * (na + 2),
                     accel=[5.0] * na, max_speed=[-1.0] * (na + 2))
        adv_dim = 2 * 2 + 2 * N                 # 8 for N=2
        good_dim = 2 + 2 * 2 + 2 * N            # 10 for N=2
        self._dim_info((adv_dim,) + (good_dim,) * N, (self.act_dim,) * na)
        self.other_idx = torch.as_tensor(_others(na), device=self.device)

    def _goal_pos(self, state: MPEState) -> torch.Tensor:
        rows = torch.arange(state.pos.shape[0], device=state.pos.device)
        return state.pos[rows, self.n_agents + state.goal]     # (B, 2)

    def _rewards(self, state: MPEState) -> torch.Tensor:
        apos = state.pos[:, :self.n_agents]
        d_goal = torch.sqrt(torch.sum(
            (apos - self._goal_pos(state)[:, None]) ** 2, dim=-1) + 1e-8)
        adv_d = d_goal[:, 0]
        good_rew = -torch.amin(d_goal[:, 1:], dim=1) + adv_d
        return torch.cat([-adv_d[:, None],
                          good_rew[:, None].expand(-1, self.n_good)], dim=1)

    def observation(self, state: MPEState) -> torch.Tensor:
        na = self.n_agents
        b = state.pos.shape[0]
        apos, lpos = state.pos[:, :na], state.pos[:, na:]
        lm_rel = (lpos[:, None] - apos[:, :, None]).reshape(b, na, -1)
        other_rel = (apos[:, self.other_idx] - apos[:, :, None]).reshape(
            b, na, -1)
        goal_rel = self._goal_pos(state)[:, None] - apos
        adv = torch.cat([lm_rel[:, 0], other_rel[:, 0]], dim=-1)
        good = torch.cat([goal_rel[:, 1:], lm_rel[:, 1:], other_rel[:, 1:]],
                         dim=-1)
        return self._pad([adv] + list(good.unbind(1)))


# ---------------------------------------------------------------------------
class SimpleTag(MPEBase):
    """Predator-prey: the adversaries (first) chase the good agents (last)
    among 2 collidable obstacles; +10 / -10 per catch and a boundary
    penalty for the prey."""

    name = "simple_tag_v3"

    def __init__(self, num_good: int = 1, num_adversaries: int = 3,
                 continuous_actions: bool = True, device="cuda"):
        super().__init__(device)
        self.continuous_actions = continuous_actions
        self.n_adv, self.n_good = num_adversaries, num_good
        na = self.n_agents = num_adversaries + num_good
        self._tables(
            sizes=[0.075] * self.n_adv + [0.05] * num_good + [0.2] * 2,
            movable=[1] * na + [0] * 2, collide=[True] * (na + 2),
            accel=[3.0] * self.n_adv + [4.0] * num_good,
            max_speed=[1.0] * self.n_adv + [1.3] * num_good + [-1.0] * 2)
        adv_dim = 4 + 2 * 2 + 2 * (na - 1) + 2 * num_good
        good_dim = 4 + 2 * 2 + 2 * (na - 1) + 2 * (num_good - 1)
        self._dim_info((adv_dim,) * self.n_adv + (good_dim,) * num_good,
                       (self.act_dim,) * na)
        self.other_idx = torch.as_tensor(_others(na), device=self.device)

    def _rewards(self, state: MPEState) -> torch.Tensor:
        adv_pos = state.pos[:, :self.n_adv]
        good_pos = state.pos[:, self.n_adv:self.n_agents]
        catch = _dist(adv_pos, good_pos) < (0.075 + 0.05)
        n_catch = torch.sum(catch, dim=(1, 2)).to(torch.float32)
        adv_rew = (10.0 * n_catch)[:, None].expand(-1, self.n_adv)
        good_rew = -10.0 * torch.sum(catch, dim=1).to(torch.float32)
        good_rew = good_rew - torch.sum(_bound(good_pos), dim=-1)
        return torch.cat([adv_rew, good_rew], dim=1)

    def observation(self, state: MPEState) -> torch.Tensor:
        na = self.n_agents
        b = state.pos.shape[0]
        apos, avel = state.pos[:, :na], state.vel[:, :na]
        lpos = state.pos[:, na:]
        lm_rel = (lpos[:, None] - apos[:, :, None]).reshape(b, na, -1)
        other_rel = (apos[:, self.other_idx] - apos[:, :, None]).reshape(
            b, na, -1)
        obs = []
        for i in range(na):
            # the velocities of the good agents other than itself
            good = [avel[:, j] for j in range(self.n_adv, na) if j != i]
            obs.append(torch.cat([avel[:, i], apos[:, i], lm_rel[:, i],
                                  other_rel[:, i], *good], dim=-1))
        return self._pad(obs)


# ---------------------------------------------------------------------------
class SimpleWorldComm(MPEBase):
    """simple_world_comm_v3: a leader adversary (speaks, dim_c 4) and 3
    adversaries chase ``num_good`` food-seeking good agents among one
    collidable landmark, 2 food sources and 2 forests.

    Entities: [leader, adversaries, good agents], then [landmark, food x2,
    forest x2]. The leader's action is 9 wide (5 moves + 4 comm), the
    others' 5 (``agent_act_dims``). Forest concealment: another agent's
    relative position and velocity read as zeros unless observer and
    observed share a forest, both are outside every forest, or the observer
    is the leader, who sees everything. Continuous actions only.
    """

    name = "simple_world_comm_v3"
    dim_c = 4
    state_cls = WorldCommState

    def __init__(self, num_good: int = 2, num_adversaries: int = 4,
                 continuous_actions: bool = True, device="cuda"):
        if not continuous_actions:
            raise ValueError("simple_world_comm takes continuous actions only")
        super().__init__(device)
        self.n_adv, self.n_good = num_adversaries, num_good
        na = self.n_agents = num_adversaries + num_good
        self._tables(
            sizes=[0.075] * self.n_adv + [0.045] * num_good
            + [0.2, 0.03, 0.03, 0.3, 0.3],
            movable=[1] * na + [0] * 5,
            # the landmark is an obstacle; food and forests are intangible
            collide=[True] * na + [True, False, False, False, False],
            accel=[3.0] * self.n_adv + [4.0] * num_good,
            max_speed=[1.0] * self.n_adv + [1.3] * num_good + [-1.0] * 5)
        adv_dim = 4 + 2 * 5 + 2 * (na - 1) + 2 * num_good + 2 + self.dim_c
        good_dim = 4 + 2 * 5 + 2 * (na - 1) + 2 + 2 * (num_good - 1)
        self._dim_info((adv_dim,) * self.n_adv + (good_dim,) * num_good,
                       (5 + self.dim_c,) + (5,) * (na - 1))
        self.i_food = na + 1
        self.i_forest = na + 3

    def _initial(self, draw: torch.Tensor) -> dict:
        return dict(super()._initial(draw),
                    comm=draw.new_zeros((draw.shape[0], self.dim_c)))

    def _update_comm(self, state: WorldCommState, a: torch.Tensor) -> None:
        # only the leader speaks: c <- action[5:9]
        state.comm = a[:, 0, 5:5 + self.dim_c]

    def _in_forest(self, state) -> torch.Tensor:
        """(B, A, 2) bool: agent a overlaps forest f."""
        apos = state.pos[:, :self.n_agents]
        fpos = state.pos[:, self.i_forest:self.i_forest + 2]
        return _dist(apos, fpos) < self.sizes[:self.n_agents, None] + 0.3

    def _rewards(self, state) -> torch.Tensor:
        na = self.n_agents
        adv_pos = state.pos[:, :self.n_adv]
        good_pos = state.pos[:, self.n_adv:na]
        good_size = self.sizes[self.n_adv:na]

        d_ag = _dist(adv_pos, good_pos)                    # (B, n_adv, n_good)
        catch = d_ag < (0.075 + good_size)
        n_catch = torch.sum(catch, dim=(1, 2)).to(torch.float32)
        # adversaries (the leader too): -0.1 * the nearest prey's distance,
        # +5 per (adversary, good) contact anywhere in the pack
        adv_rew = -0.1 * torch.amin(d_ag, dim=2) + 5.0 * n_catch[:, None]

        # good agents: -5 per adversary touching them, twice the boundary
        # penalty, +2 per food eaten, +0.05 * the nearest food's distance
        food_pos = state.pos[:, self.i_food:self.i_food + 2]
        d_food = _dist(good_pos, food_pos)                 # (B, n_good, 2)
        eat = d_food < (good_size[:, None] + 0.03)
        good_rew = (
            -5.0 * torch.sum(catch, dim=1).to(torch.float32)
            - 2.0 * torch.sum(_bound(good_pos), dim=-1)
            + 2.0 * torch.sum(eat, dim=-1).to(torch.float32)
            + 0.05 * torch.amin(d_food, dim=-1)
        )
        return torch.cat([adv_rew, good_rew], dim=1)

    def observation(self, state) -> torch.Tensor:
        na = self.n_agents
        b = state.pos.shape[0]
        apos, avel = state.pos[:, :na], state.vel[:, :na]
        ent_rel = (state.pos[:, None, na:] - apos[:, :, None]).reshape(
            b, na, -1)
        inf = self._in_forest(state)                          # (B, A, 2)
        outside = ~torch.any(inf, dim=-1)                     # (B, A)
        forest_flag = torch.where(inf, 1.0, -1.0)
        # may observer i see agent j (the leader sees all)
        vis = ((inf[:, :, None, 0] & inf[:, None, :, 0])
               | (inf[:, :, None, 1] & inf[:, None, :, 1])
               | (outside[:, :, None] & outside[:, None, :]))
        vis[:, 0, :] = True
        vis = vis[..., None]

        obs = []
        for i in range(na):
            other_rel = [torch.where(vis[:, i, j], apos[:, j] - apos[:, i],
                                     0.0) for j in range(na) if j != i]
            good_vel = [torch.where(vis[:, i, j], avel[:, j], 0.0)
                        for j in range(self.n_adv, na) if j != i]
            if i < self.n_adv:      # leader and adversaries hear the channel
                obs.append(torch.cat([avel[:, i], apos[:, i], ent_rel[:, i],
                                      *other_rel, *good_vel,
                                      forest_flag[:, i], state.comm], dim=-1))
            else:                   # the published layout: forest flags first
                obs.append(torch.cat([avel[:, i], apos[:, i], ent_rel[:, i],
                                      forest_flag[:, i], *other_rel,
                                      *good_vel], dim=-1))
        return self._pad(obs)
