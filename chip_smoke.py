"""Drive the PyTorch port on one CUDA card and check it, phase by phase.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. device: require a CUDA card; print its name and power limit;
2. build every kernel under freerl_tpu_torch/csrc with nvcc;
3. each kernel against its plain PyTorch twin on the card, bit for bit,
   at several shapes and inputs; then, at the main path's shape, the
   kernel's, the twin's and the library yardstick's device times (CUDA
   events over a CUDA graph of back-to-back calls, so host overhead is left
   out) with L2 warm and, for the kernel, cold; the empty-kernel floor of
   one launch on the kernel's grid; and the eager call times of the kernel
   and the yardstick, host overhead included;
   then the walker's kernels (``csrc/bipedal_step.cu``): K3
   (``bipedal_reset``) on 4, 8, 10 and 1,024 rows against the plain
   version on the CPU (the terrain bit-equal), K2 (``bipedal_step``)
   through ``step_auto_reset`` against the plain version on the card over
   100 teacher-forced steps of 4, 8, 10 and 256 envs (the main path's
   counts, each part of one block, and two whole blocks) at the CPU
   phase's rule (item 11), each count held on its own, and at 8, 256 and
   1,024 envs each kernel's and the plain version's device time, the
   launch floor, the bound (K2's bytes count the terrain floats the step
   reads, K2's and K3's operations the lidar samples the data needs), and
   the vector step as the
   loops call it with the kernels and with the plain version, with its
   kernels a step;
4. the port on the card against the port on the CPU at small sizes
   (LunarLander steps, DQN updates, the PER buffer), then for the trick
   matrix and the discrete envs: five Rainbow updates from identical
   params, batch and noise, ``c51_project``, a per-row noisy forward at
   1024 rows, ``nstep_fold``, and 200 steps of each classic and tabular
   env;
5. the main path: train_offpolicy on LunarLander-v2 with
   DQNConfig(per=True, per_sampler="tree") at full width (8-128-4 net,
   buffer 1e6 -> 2^20, batch 256), 1024 envs; the sum-tree kernel must be
   launched once per learner step;
6. the same loop with uniform replay (per=False);
7. Rainbow at full width: the same loop with double, dueling, PER (tree),
   noisy, 3-step and C51 heads (noisy A head 128 -> 4*51, noisy V head
   128 -> 51); it reaches the sum-tree kernel through ``sample_idx`` and
   the n-step fold, once per learner step;
8. the discrete env family at 1024 envs: CartPole-v1, MountainCar-v0,
   FrozenLake-v1, Taxi-v3, and Pendulum-v1 and MountainCarContinuous-v0
   through ``dis_to_con`` (16 bins), each trained by DQN with double,
   dueling and uniform 3-step replay for 224 vector steps; returns must lie
   in each env's range (an untrained MountainCar episode ends at -200);
9. the continuous family on the card against the CPU: five updates of
   each of the nine DDPG / TD3 / SAC variants at full width, 200 steps of
   LunarLanderContinuous at 1024 envs, and ``relabel_future``;
10. DDPG, TD3 and SAC on LunarLanderContinuous-v2 at full width, 1024
    envs, 256 vector steps; discrete DDPG (softmax and Gumbel actors) and
    discrete SAC on CartPole-v1; ``train_her`` with DDPG on
    GoalPendulum-v1; none of them launches the sum-tree kernel;
11. (in the block of 24) the on-policy slice on the card against the
    CPU: ``gae`` on a
    64 x 1024 rollout, one full update at full width (2x128) of each PPO
    branch (Gaussian, discrete, Beta, all tricks, ``recompute_logp``,
    ``std_decay``), one REINFORCE update, and 100 teacher-forced
    auto-resetting BipedalWalker steps at 256 envs;
12. (in the block of 24) train_onpolicy at 1024 envs for 2 iterations:
    PPO (its defaults,
    2x128, T 16) on BipedalWalker-v3, PPO with reward_scaling on
    CartPole-v1 (T 16), REINFORCE on CartPole-v1 (T 64);
    the episode record must equal the RAW rewards' sums, REINFORCE must
    take one Adam step per filled episode slot, and none of them launches
    the sum-tree kernel;
13. the multi-agent slice on the card against the CPU: 60 teacher-forced
    auto-resetting steps of each MPE scenario (spread, adversary, tag,
    world comm) and of the masked spread at 1024 envs, and one learner
    step at full width (2x128, batch 256) of MADDPG, MATD3 (two steps, one
    delayed), ATT-MADDPG, MADDPG with the Gaussian actor, MADDPG on world
    comm, MASAC and MAAC (discrete spread);
14. train_marl at the configs' defaults (2x128, batch 256, replay 1e6),
    1024 envs: MADDPG on simple_spread_v3 for 256 vector steps; MATD3,
    ATT-MADDPG and MASAC on simple_spread_v3, MAAC on the discrete spread
    and MADDPG on simple_world_comm_v3 for 64 each; the (E, A) record
    must equal each agent's sums of the raw rewards and lie in the
    scenario's ranges, the learner must step once per vector step, and
    none of them launches the sum-tree kernel; each path's kernels per
    vector step are profiled;
15. (in the block of 24) the multi-agent on-policy slice on the card
    against the CPU, at full
    width from identical params and draws: one ``sample_action`` and one
    full update of MAPPO (stacked, all 12 tricks, the attention critic,
    masked, world comm), IPPO on simple_adversary_v3, HAPPO, MAT
    (discrete and continuous), rMAPPO and rIPPO (their hidden states
    carried over 16 sampling steps), each update that of a (T 16, N 64)
    rollout, every Adam step held against the CPU's, free-running for
    the variant's first ``FREE_STEPS`` steps and from the CPU's state
    after that;
16. (in the block of 24) train_onpolicy with the configs' defaults
    (2x128; MAT n_embd 64;
    rMAPPO GRU 64) but ``num_envs`` and ``horizon``: MAPPO on
    simple_spread_v3 (1024 envs, T 4, 7 iterations), IPPO on
    simple_adversary_v3, HAPPO and MAT on spread and MAPPO on
    simple_world_comm_v3 (1024 envs, T 4, 2 iterations), rMAPPO on spread
    (256 envs, one 10-step chunk); each agent's running return and the
    (E, A) record equal the RAW rewards' sums, one update per iteration,
    no sum-tree launch; kernels per vector step and per Adam step
    profiled;
17. slice 6 on the card against the CPU, at the configurations' widths
    from identical params and draws: GAIL's ``train_d`` (vanilla, and
    WGAN-GP with LayerNorm) and ``compute_reward``; one CEM-GD3PG
    ``learn`` of each guidance branch and a P=10 ``eval_population`` on
    Pendulum-v1 (its 200-step rollout teacher-forced); ENVELOPE's
    ``add_with_priority``, ``sample`` and ``update`` and one
    ``EnvelopeDDPG`` learner step; a DQN update
    through the 'small' and the 'nature' conv trunk; 200 teacher-forced
    auto-resetting steps of PixelCartPole-v1 and deep-sea-treasure-v0 at
    1024 envs;
18. the slice-6 paths at the configurations' widths: GAIL on Pendulum-v1
    (scripts/gail_e2e.py's learner: expert pairs from
    ``collect_expert_data``, three ``train_gail`` iterations at 8 envs,
    then D must tell the expert from the policy); CEM-GD3PG on
    Pendulum-v1 with its defaults for 12 episodes (one ES tell / ask
    cycle and the elite mixing), then its learner burst as a CUDA graph
    against the eager loop at scripts/r5_cem_bipedal.py's config on the
    walker's widths, 200 learner steps over both branches, params and Adam
    moments bit-equal; ENVELOPE through ``train_offpolicy`` on
    deep-sea-treasure-v0 with its defaults, 1024 envs, 96 vector steps
    (the record equals the raw rewards scalarized with
    ``record_weights``); pixel DQN on PixelCartPole-v1 (pixel_curve.py's
    config, 512 envs, 64 vector steps) and one ``train_onpolicy``
    iteration of a conv-trunk PPO (256 envs, T 16); returns in each env's
    range, and none of them launches the sum-tree kernel;
19. slice 7 on the card against the CPU: the algo state of Rainbow DQN,
    DDPG with PopArt and ObsNorm, TD3 (saved inside its delay phase), PPO
    with every trick, MAPPO (stacked) and MATD3 at full width, after a few
    updates, saved with ``save_checkpoint`` on the card, loaded on the CPU
    (every tensor and host field bit for bit) and on the card, where one
    more update of the live and of the restored state from identical
    inputs and draws must stay bit-equal (``CHECKPOINT_CASES``); 100 steps
    of ``HostSmacVecEnv(FakeSmacEnv, use_state=True)`` at 64 envs,
    identical on the card and the CPU;
20. the slice-7 paths through the user's entry points: ``cli.run`` (DQN
    with PER on LunarLander-v2, 1024 envs, replay 1e6, batch 256, 2048
    episodes, ``--save_freq 1024``; the run dir ``DQN_PER_1`` with
    ``config.json``, the curve and ``checkpoint``), ``eval.score`` on that
    run dir over 100 held-out episodes, and the checkpoint's size and its
    save and load times; ``HostVecEnv`` around ``NumpyCartPole`` (no
    gymnasium needed) with 0 and 2 worker processes under DQN through
    ``train_offpolicy`` (the record equals the raw rewards' sums); masked
    MAPPO with the state-augmented critic on ``fake-smac`` through
    ``cli.build`` and ``train_onpolicy`` (no unavailable action reaches
    the envs); ``utils.profiling.trace`` around 8 vector steps of the
    main path (the Chrome trace holds CUDA kernel events);
21. slice 8, data-parallel training on ``torch.distributed``: two ranks
    spawned on the one card (gloo; NCCL takes one card per rank), each
    with half of the envs: the main path (DQN + PER tree on LunarLander-v2
    at full width, 1024 envs in all, replay 1e6 and PER 2^20 per rank,
    batch 256 per rank, 128 vector steps) through ``train_offpolicy(mesh=)``,
    MADDPG on simple_spread_v3 through ``train_marl(mesh=)`` and PPO with
    obs_norm, reward_scaling and adv_norm on CartPole-v1 through
    ``train_onpolicy(mesh=)``; every replicated tensor (nets, Adam,
    normalizer stats) bit-equal across the ranks, B1 once per learner step
    on each rank of the main path and never on the others, the merged
    record equal to the ranks' raw rewards merged by (step, rank), the
    gradient all-reduce timed; then, in the same ranks, one sharded update
    of DQN (PER weights), PPO and MADDPG on the card against the same on
    the CPU's gloo group, from the same params and per-rank batches;
22. a one-rank NCCL group in this process: DQN updates with ``axis_name``
    bit-equal to the same updates with no mesh;
23. ``golden.regenerate`` on a 25-episode CartPole recipe on the card,
    into a temporary directory;
24. the learning checks of ``LEARNING_CHECKS`` (DQN on CartPole-v1, SAC
    on Pendulum-v1, PPO on CartPole-v1, MATD3 and MAPPO on
    simple_spread_v3), seed 0, side by side with the recipes of 30 and
    the phases 11, 12, 15 and 16 (``BLOCK_PHASES``, moved here from their
    places in the order): each
    in a spawned process of its own on the card (``side_by_side``), all
    joined before the next phase; the mean return of the last episodes
    must clear each check's threshold, a check that fails or outlives
    ``LEARNING_TIMEOUT_S`` (a recipe, ``N5_TIMEOUT_S``) fails the run, and
    none may move a global random state;
25. the port's bench (``freerl_tpu_torch/bench.py``): ``bench_dqn`` at
    the headline size (4096 envs, chunk 256, 2 measured chunks), its env
    steps counted, its rate finite, its peak memory printed, no sum-tree
    launch; then ``python -m freerl_tpu_torch.bench`` with
    ``BENCH_SKIP_EXTRA=1 BENCH_CHUNKS=2`` in a subprocess, its last line
    the bench's JSON with ``"vs_baseline": null``;
26. ``scripts/torch_per_bench.py`` at 2^20 and batch 256: the tree sampler
    launches the sum-tree kernel once per ``sample``, cumsum never;
27. the north-star run (``scripts/torch_northstar.py``'s ``run_point``: DQN
    on LunarLander-v2, replay 2^20, batch 256, 4096 envs, 8 updates per
    vector step) for 8 chunks of 64 vector steps: exactly 2,097,152 env
    steps and 4,088 updates, a finite record, no sum-tree launch; its
    steady env-steps/s with the card's name and power limit;
28. the parity gate of ``golden.JAX_PARITY``: the port's committed curves
    against the JAX package's curves of the same stem, or, for a row keyed
    ``@jax_head``, against the JAX package rerun at this commit on the CPU
    (``golden.check_against_jax``); a row fails only under an open fault
    of ``golden.OPEN_FAULTS`` or a stale reference of
    ``golden.STALE_REFERENCES``, or where the gate, not the port, misses
    (``golden.UNDERPOWERED``), and such a row must fail; an
    absent curve fails the phase; the scalar gates of
    ``golden.SCALAR_GATES`` (the GAIL imitation gate, on the port's newest
    ``results/torch/gail`` summary) are held the same way;
29. the fixed-reset starts: for every env and seed of a ``--fixed_reset``
    row of ``golden.JAX_PARITY``, the env built as the CLI builds it on the
    card and on the CPU pins one start (the JAX package's draw, made on the
    host): the draws bit-equal, the start observations within
    ``golden.START_ULPS`` float32 ulps (``golden.same_start``);
30. in the block of 24, the N=5 multi-agent recipes (``golden.N5_RUNS``:
    the nine spread tags
    at N=5, IPPO on the adversary at seed 0 and on layout 100 through
    ``--reset_seed``, and MAPPO with attention at N=30), each built by the
    port's CLI from its argv and trained on the card for a few episodes
    (``n5_recipe``), scripts/train_spread.py's
    MASAC run (``golden.SPREAD_RUNS``: the JAX script's config through the
    CLI's argv, 16 envs, batch 256, a replay of 1e6, random resets) for 3
    chunks (``spread_recipe``), and scripts/envelope_seed_sweep.sh's
    ENVELOPE run (``golden.ENVELOPE_RUNS``: 1 env, batch 256, a replay of
    1e6, one learner step an env step) for 3 chunks, then the
    100-preference sweep of scripts/torch_envelope_e2e.py on the state it
    reached (``envelope_recipe``): finite records of
    ``(episodes, n_agents)``, a learner step, the observations of the env
    at each agent's width, ``golden.bin_curve`` of the MASAC record, 100
    finite sweep returns with precision, recall and CR in [0, 1], no
    sum-tree launch; scripts/pixel_curve.py's run (``golden.PIXEL_RUNS``:
    a replay of 1e5, batch 64, the small conv trunk, 8 envs, 4 updates a
    vector step) through ``scripts/torch_pixel_curve.train`` for 2 chunks
    (``pixel_recipe``): returns in [1, 500] and the learner stepping on
    every vector step past the 1,000 start steps; and scripts/gail_e2e.py's
    four stages (``golden.GAIL_RUNS``) through
    ``scripts/torch_gail_e2e.run`` with 8 expert episodes and 2 GAIL
    iterations (``gail_recipe``): the artifact set whole, finite, and read
    by ``golden.check_scalar``; scripts/r5_cem_bipedal.py's draw 0
    (``golden.CEM_BIPEDAL_RUNS``) through
    ``scripts/torch_r5_cem_bipedal.train`` for its first ES generation
    and two episodes more (``cem_bipedal_recipe``: finite returns, one
    learner step a burst row from the kept CUDA graphs, K2 and K3
    launched), and r5_singles.py's PPO BipedalWalker run at its first
    seed through the CLI's build for 3 updates (``ppo_bipedal_recipe``:
    K2 once a vector step); none launches the sum-tree kernel;
31. determinism: the same seed twice on the card, the records and every
    tensor of the final states bit-equal, each run with an optimizer step
    after its warm-up: DQN on CartPole-v1 seed 7 and PPO on Pendulum-v1
    seed 3 (the JAX package's tests/test_determinism.py configs), the main
    path (DQN + PER tree on LunarLander-v2 at full width, 1024 envs, 64
    vector steps); then, at the other phases' widths and cut in envs and
    steps: DQN with uniform replay and Rainbow (B1) on LunarLander-v2 (256
    envs, 32 steps), the family's DQN (double, dueling, 3-step) on
    Pendulum-v1 through ``dis_to_con``; DDPG, TD3 and SAC on
    LunarLanderContinuous-v2 and discrete DDPG (softmax, Gumbel) and SAC on
    CartPole-v1 (256 envs, 16 steps); HER with DDPG on GoalPendulum-v1 (64
    envs, one episode, 20 updates); PPO on BipedalWalker-v3 (8 envs, T 8)
    and REINFORCE on CartPole-v1 (64 envs, T 64), one iteration; each
    entry of ``MARL_PATHS`` (128 envs, 8 steps) and of
    ``MARL_ONPOLICY_PATHS`` (one iteration of 64 envs, rMAPPO 32 x T 10);
    GAIL on Pendulum-v1 (2048 expert pairs, one iteration of 256 steps),
    CEM-GD3PG on Pendulum-v1 (2 episodes, 20 updates each), ENVELOPE on
    deep-sea-treasure-v0 (256 envs, 16 steps); and, once with TF32 off and
    once with cuDNN's TF32 at torch's default, pixel DQN with the small
    trunk on PixelCartPole-v1 (64 envs, 32 steps), conv PPO on
    PixelCartPole-v1 (32 envs, T 16) and one DQN update through the nature
    trunk at (84, 84, 4), batch 64 (the grads and the new state); every
    path is run and each that differs is named before the phase fails;
32. stop the processes the run started and that would outlive it (the
    forkserver behind ``HostVecEnv``'s workers and multiprocessing's
    resource tracker); any other child still running fails the run;
33. print one JSON line describing each kernel: B1 (with its launches on
    the main path, and on the Rainbow, continuous, on-policy, multi-agent
    on-policy, multi-agent, slice-6, slice-7, data-parallel, bench,
    per-bench, north-star, N=5 recipe, spread recipe, envelope recipe,
    pixel recipe, GAIL recipe and the two walker recipes' paths), K2 and
    K3 (with their launches on the CEM-GD3PG walker recipe, this slice's
    main path, and on the PPO walker recipe); the card line, and the
    result line.

It needs no network, builds everything from the checkout, and leaves no
process running when it exits, whether it passed or failed.
"""
from __future__ import annotations

import copy
import ctypes
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import types

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12     # HBM3, NVIDIA H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12     # f32 outside the tensor cores, same source

MAIN_CAP_POW, MAIN_BATCH = 20, 256


def log(msg: str) -> None:
    print(msg, flush=True)


def child_processes() -> dict[int, str]:
    """The children of this process that still run (zombies left out):
    pid -> command line."""
    me, out = os.getpid(), {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if int(ppid) == me and state != "Z":
            out[int(entry)] = cmd.strip()
    return out


def stop_children() -> dict[int, str]:
    """Stop the helpers that multiprocessing starts and keeps until this
    process has exited: the forkserver that ``HostVecEnv`` starts its
    workers from, and the resource tracker. Each is asked to stop and is
    reaped. Then kill and reap any other child still running, and return
    those (pid -> command line): none is expected."""
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
    left = child_processes()
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass
    return left


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class NumpyCartPole:
    """gymnasium's CartPole-v1 in numpy, for ``HostVecEnv`` where
    gymnasium is absent: its Euler dynamics on a float64 state, its
    ``np_random`` reset (``default_rng(seed)``, U(+-0.05)), its 500-step
    time limit, and spaces read by duck typing (an action space with
    ``.n``, an observation space with ``.shape``)."""

    gravity, masscart, masspole, length = 9.8, 1.0, 0.1, 0.5
    force_mag, tau, x_threshold = 10.0, 0.02, 2.4
    theta_threshold = 12 * 2 * np.pi / 360
    max_episode_steps = 500

    def __init__(self):
        self.action_space = types.SimpleNamespace(n=2)
        self.observation_space = types.SimpleNamespace(shape=(4,))
        self.spec = types.SimpleNamespace(
            id="NumpyCartPole-v1", reward_threshold=475.0,
            max_episode_steps=self.max_episode_steps)
        self._rng = np.random.default_rng()
        self.state, self._t = None, 0

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.state = self._rng.uniform(low=-0.05, high=0.05, size=(4,))
        self._t = 0
        return np.array(self.state, dtype=np.float32), {}

    def step(self, action):
        x, x_dot, theta, theta_dot = self.state
        total_mass = self.masspole + self.masscart
        polemass_length = self.masspole * self.length
        force = self.force_mag if action == 1 else -self.force_mag
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + polemass_length * np.square(theta_dot) * sintheta
                ) / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta)
                           / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        self._t += 1
        terminated = bool(x < -self.x_threshold or x > self.x_threshold
                          or theta < -self.theta_threshold
                          or theta > self.theta_threshold)
        truncated = self._t >= self.max_episode_steps
        return (np.array(self.state, dtype=np.float32), 1.0, terminated,
                truncated, {})


def build_tree(cap: int, seed: int = 0, spike_leaf: int | None = None,
               empty_half: bool = False):
    """A sum-tree over uniform random leaves (optionally one leaf raised by
    1000, or the upper half of the leaves zero, as in a half-filled
    buffer), summed level by level in f32."""
    depth = cap.bit_length() - 1
    rng = np.random.RandomState(seed)
    tree = np.zeros(2 * cap, np.float32)
    tree[cap:] = rng.rand(cap)
    if spike_leaf is not None:
        tree[cap + spike_leaf] += 1000.0
    if empty_half:
        tree[cap + cap // 2:] = 0.0
    for lvl in range(depth - 1, -1, -1):
        lo, hi = 1 << lvl, 1 << (lvl + 1)
        tree[lo:hi] = tree[2 * lo: 2 * hi: 2] + tree[2 * lo + 1: 2 * hi: 2]
    return torch.from_numpy(tree).cuda(), depth


def stratified_u(tree: torch.Tensor, batch: int, seed: int) -> torch.Tensor:
    r = np.random.RandomState(seed).rand(batch)
    total = float(tree[1])
    return torch.from_numpy(
        ((np.arange(batch) + r) * total / batch).astype(np.float32)
    ).cuda()


def masses(tree: torch.Tensor, batch: int, kind: str, seed: int):
    """The masses of one check: stratified over the root's total, all zero,
    or at and above the total (the last one +inf when batch > 1), where
    every step goes right and the clip holds the result."""
    if kind == "stratified":
        return stratified_u(tree, batch, seed)
    if kind == "zero":
        return torch.zeros(batch, device="cuda")
    total = np.float32(tree[1].item())
    u = (total * (1 + np.arange(batch) / batch)).astype(np.float32)
    if batch > 1:
        u[-1] = np.inf
    return torch.from_numpy(u).cuda()


def device_ms(fn, calls: int = 100, replays: int = 20) -> float:
    """Device time per call: ``calls`` back-to-back calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def cold_ms(fn, flush_bytes: int = 128 << 20) -> tuple[float, float]:
    """Device time per call with L2 cold: each call is preceded in the graph
    by a write of ``flush_bytes`` (more than the 50 MB L2), and the flush's
    own time is taken off. Returns (time per call, flush time)."""
    buf = torch.empty(flush_bytes // 4, device="cuda")

    def flush():
        buf.fill_(1.0)

    def both():
        flush()
        fn()

    flush_ms = device_ms(flush, calls=50, replays=10)
    return device_ms(both, calls=50, replays=10) - flush_ms, flush_ms


def eager_ms(fn, calls: int = 200) -> float:
    """Time per call as the main path makes it: back-to-back eager calls,
    host overhead included."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def eager_medians(fns: dict, rounds: int = 6, calls: int = 1000) -> dict:
    """``eager_ms`` of each function, taken in ``rounds`` rounds that
    alternate the order (the host's clock drifts within a call); returns
    the median of each."""
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(eager_ms(fns[name], calls))
    return {name: float(np.median(t)) for name, t in times.items()}


# ---------------------------------------------------------------------------
def phase_build():
    from freerl_tpu_torch.ops import _build

    t0 = time.time()
    reports = _build.build_all()
    log(f"[build] {sorted(reports)} built in {time.time() - t0:.2f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


SUMTREE_CAP_POWS = (0, 1, 3, 8, 13, 14, 17, 20, 21)
SUMTREE_BATCHES = (1, 255, 256, 4096)
SUMTREE_TREES = ("uniform", "spike", "empty_half")
SUMTREE_MASSES = ("stratified", "zero", "over_total")


def sumtree_cases():
    """Yield (label, spike leaf or None, tree, depth, cap, u) for every
    check of the descent."""
    for cap_pow in SUMTREE_CAP_POWS:
        cap = 1 << cap_pow
        for kind in SUMTREE_TREES:
            spike = 77 % cap if kind == "spike" else None
            tree, depth = build_tree(cap, seed=cap_pow, spike_leaf=spike,
                                     empty_half=kind == "empty_half")
            for batch in SUMTREE_BATCHES:
                for mass in SUMTREE_MASSES:
                    u = masses(tree, batch, mass, seed=batch + cap_pow)
                    yield (f"cap 2^{cap_pow}, {kind} tree, B={batch}, "
                           f"{mass} masses",
                           spike if mass == "stratified" else None,
                           tree, depth, cap, u)


def floor_launcher(batch: int):
    """A call that launches the kernel library's empty kernel on the
    descent's grid for ``batch`` samples, on the current stream: the launch
    floor the descent is timed against."""
    from freerl_tpu_torch.ops import _build

    fn = _build.load("sumtree_descend").sumtree_descend_floor_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def empty():
        if fn(batch, torch._C._cuda_getCurrentRawStream(0)):
            raise RuntimeError("sumtree_descend_floor_launch failed")
    return empty


def phase_sumtree():
    from freerl_tpu_torch.ops import sumtree

    n, worst = 0, 0
    for label, spike, tree, depth, cap, u in sumtree_cases():
        out = sumtree.sumtree_descend(tree, u, depth, cap)
        ref = sumtree.sumtree_descend_ref(tree, u, depth, cap)
        worst = max(worst, int((out.long() - ref.long()).abs().max()))
        if not torch.equal(out, ref):
            bad = int((out != ref).sum())
            raise AssertionError(
                f"sumtree_descend differs from its twin at {label}: "
                f"{bad} rows")
        if spike is not None:
            want = u.numel() * 1000.0 / float(tree[1])
            got = int((out == spike).sum())
            if want >= 20 and got < 0.5 * want:
                raise AssertionError(
                    f"spiked leaf drawn {got} times, expected {want}: {label}")
        n += 1
    log(f"[sumtree] kernel == twin bit for bit in {n} cases: caps "
        f"2^{SUMTREE_CAP_POWS}, B {SUMTREE_BATCHES}, trees {SUMTREE_TREES}, "
        f"masses {SUMTREE_MASSES}")

    # timing at the main path's shape
    cap = 1 << MAIN_CAP_POW
    tree, depth = build_tree(cap, seed=1)
    u = stratified_u(tree, MAIN_BATCH, seed=2)
    cdf = torch.cumsum(tree[cap:], 0)

    def kernel():
        return sumtree.sumtree_descend(tree, u, depth, cap)

    def library():
        return torch.searchsorted(cdf, u)

    kernel_ms = device_ms(kernel)
    library_ms = device_ms(library)
    floor_ms = device_ms(floor_launcher(MAIN_BATCH))
    plain_ms = device_ms(
        lambda: sumtree.sumtree_descend_ref(tree, u, depth, cap))
    kernel_cold_ms, flush_ms = cold_ms(kernel)
    eager = eager_medians({"kernel": kernel, "library": library})
    call_ms, library_call_ms = eager["kernel"], eager["library"]

    # bound: the nodes this run's data reads (each left child once), u in,
    # idx out; two f32 operations (compare, subtract) per level and sample
    node = torch.ones(MAIN_BATCH, dtype=torch.int64, device="cuda")
    mass, touched = u.clone(), []
    for _ in range(depth):
        left_idx = 2 * node
        left = tree[left_idx]
        touched.append(left_idx)
        right = mass > left
        node = left_idx + right.long()
        mass = torch.where(right, mass - left, mass)
    distinct = int(torch.unique(torch.cat(touched)).numel())
    n_bytes = 4 * distinct + 4 * MAIN_BATCH + 4 * MAIN_BATCH
    n_ops = 2 * depth * MAIN_BATCH
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    log(f"[sumtree] cap 2^{MAIN_CAP_POW}, B {MAIN_BATCH}: kernel "
        f"{kernel_ms:.6f} ms warm, {kernel_cold_ms:.6f} ms L2-cold (flush "
        f"{flush_ms:.6f} ms taken off), empty-kernel floor {floor_ms:.6f} ms "
        f"(device, graph); eager call {call_ms:.6f} ms (median of 6 "
        f"alternating rounds); twin {plain_ms:.6f} ms; torch.searchsorted "
        f"{library_ms:.6f} ms warm, {library_call_ms:.6f} ms eager; "
        f"{distinct} distinct nodes read, "
        f"{n_bytes} B, {n_ops} f32 ops")
    return {
        "name": "sumtree_descend",
        "route": "cuda",
        "source": "freerl_tpu_torch/csrc/sumtree_descend.cu",
        "replaces": "freerl_tpu/ops/sumtree_pallas.py:92",
        "bit_exact": True,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "cold_ms": kernel_cold_ms,
        "floor_ms": floor_ms,
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "library_call_ms": library_call_ms,
    }


# ---------------------------------------------------------------------------
# The walker's kernels, K2 (step) and K3 (reset): csrc/bipedal_step.cu
# ---------------------------------------------------------------------------
# the env counts the vector step is timed at: PPO's 8 (and CEM-GD3PG's 4 and
# 10 rows in one block alike), the card-against-CPU phase's 256, and the
# on-policy phase's 1,024
WALKER_BATCHES = (8, 256, 1024)
# the env counts K2 is held to the plain version at, teacher-forced: the
# main path's (CEM-GD3PG's 4 fused lanes and 10 population rows, PPO's 8
# envs; each a part of one 128-thread block) and two whole blocks; K3 at
# the same small counts and at 1,024
WALKER_STEP_CHECKS = (4, 8, 10, 256)
WALKER_RESET_CHECKS = (4, 8, 10, 1024)


def walker_rows(out) -> torch.Tensor:
    """A step's or reset's outputs as one (B, fields) float tensor: the
    state's fields, then the observation and the rest."""
    state, *rest = out
    return torch.cat([getattr(state, f.name).reshape(state.pos.shape[0], -1)
                      .float() for f in dataclasses.fields(state)]
                     + [x.reshape(state.pos.shape[0], -1).float()
                        for x in rest], 1)


def lidar_samples(obs: torch.Tensor) -> int:
    """The lidar samples the rows' observations needed: a ray whose first
    sample at or below the ground is k took k + 1 (its reading is
    (k + 1) / 24), one with none all 24 (reading 1)."""
    return int(torch.round(obs[:, 14:24].double() * 24).sum())


def walker_terrain_reads(state, action) -> int:
    """The terrain floats K2 reads for these rows' step, each distinct one
    counted once a row: both ends of every segment the step looks up,
    taken from the plain version's lookups on the CPU from the same state
    and action. These are each contact's at the start and in every
    position iteration, the hull's, and the observation's 8 foot contacts,
    as the kernel makes them; and each lidar sample's up to its ray's
    first at or below the ground, where the kernel stops (the plain
    version looks up all 240)."""
    from freerl_tpu_torch.envs import bipedal as w

    seen = []

    class Traced(w.BipedalWalker):
        observing = False
        lidar = None

        def observation(self, state):
            self.observing = True
            try:
                return super().observation(state)
            finally:
                self.observing = False

        def _segment(self, x):
            i, frac = w.BipedalWalker._segment(x)
            if x.shape[-1] == 10 * w._LIDAR_SAMPLES:
                self.lidar = i
            elif self.observing and x.shape[-1] == w.N_CONTACT:
                seen.extend([i[:, w._FOOT_L], i[:, w._FOOT_R]])
            else:
                seen.append(i)
            return i, frac

    env = Traced("cpu")
    new, *_ = env._step_ref(to_device(state, "cpu"), action.cpu())
    # the samples each ray needs: those with none at or below the ground
    # before them
    px = new.pos[:, 0, 0:1] + env.lidar_dx
    py = new.pos[:, 0, 1:2] + env.lidar_dy
    below = (py <= w.BipedalWalker._terrain_height(env, new.terrain, px))
    below = below.reshape(-1, 10, w._LIDAR_SAMPLES).int()
    need = (torch.cumsum(below, -1) - below) == 0
    lidar = env.lidar.reshape(need.shape)
    seen.append(torch.where(need, lidar, lidar[..., :1]).flatten(1))
    read = torch.zeros(new.terrain.shape, dtype=torch.bool)
    for i in seen:
        read.scatter_(1, i, True)
        read.scatter_(1, i + 1, True)
    return int(read.sum())


def walker_step_bytes(n: int, terrain_reads: int) -> int:
    """The bytes K2 must move for n rows: each row's state (the step's
    output fields before the observation) and t, and its action in, with
    ``terrain_reads`` terrain floats in all (``walker_terrain_reads``);
    the output fields, t and two flags out."""
    from freerl_tpu_torch.ops import bipedal as kern

    off = kern.out_offsets(kern.STEP_OUT)
    row = (off["obs"] + 1 + 4) * 4 + off["total"] * 4 + 4 + 2
    return n * row + 4 * terrain_reads


def walker_reset_bytes(n: int) -> int:
    """The bytes K3 must move for n rows: each row's 210-float draw in; its
    terrain, start state, observation and t out."""
    from freerl_tpu_torch.ops import bipedal as kern

    return n * (210 * 4 + kern.out_offsets(kern.RESET_OUT)["total"] * 4 + 4)


def walker_bound(n_bytes: float, n_ops: float) -> tuple:
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def walker_teacher_forced(cpu, card, plain, b: int, steps: int = 100,
                          seed: int = 0) -> tuple:
    """K2 through ``step_auto_reset`` against the plain version on the
    card, ``b`` envs x ``steps`` steps, each from the plain version's state,
    with the CPU phase's draws: (row-steps past rtol 1e-5 / atol 2e-5, the
    worst abs err, done flags that differ)."""
    from freerl_tpu_torch.envs import step_auto_reset, vec_reset

    gen = torch.Generator().manual_seed(seed)
    state, _ = vec_reset(cpu, gen, b)
    state = to_device(state, "cuda")
    flips, stiff, worst = 0, 0, 0.0
    fields = ("next_obs", "carry_obs", "reward")
    for _ in range(steps):
        action = (torch.rand(b, 4, generator=gen) * 2.0 - 1.0).cuda()
        reset_draw = cpu.draw_reset(b, gen).cuda()
        want = step_auto_reset(plain, state, action, None, reset_draw)
        got = step_auto_reset(card, state, action, None, reset_draw)
        same = want.episode_done == got.episode_done
        flips += int((~same).sum())
        a, c = (torch.cat(
            [getattr(out, f).reshape(b, -1) for f in fields]
            + [getattr(out.state, f.name).reshape(b, -1).float()
               for f in dataclasses.fields(out.state)], 1)[same].cpu()
            for out in (want, got))
        err = (a - c).abs()
        stiff += int((~(err <= 2e-5 + 1e-5 * a.abs()).all(1)).sum())
        worst = max(worst, float(err.max()))
        state = want.state
    return stiff, worst, flips


def phase_bipedal_kernel() -> list:
    """K3 against the plain version (``_reset_ref``) at each of
    ``WALKER_RESET_CHECKS`` rows from the same draws: on the CPU, bit for
    bit in the terrain and within rtol 1e-5 / atol 2e-5 everywhere (the
    same float32 operations; only the contact flags read cos and sin); K2
    through ``step_auto_reset`` against the plain version on the card at
    each of ``WALKER_STEP_CHECKS`` envs x 100 teacher-forced steps, with
    the CPU phase's draws and rule, at each count on its own
    (``phase_card_vs_cpu_onpolicy``: rtol 1e-5 / atol 2e-5 on every
    row-step, at most 0.5% past it and none past 5e-3, at most 0.1% of
    done flags flipped). Then, at each of ``WALKER_BATCHES``, the kernels'
    and the plain version's device times (CUDA graphs), the launch floor,
    the vector step as the loops call it (``step_auto_reset``, eager, host
    included) with the kernels and with the plain version, and each one's
    kernels a vector step (profiled). Returns K2's and K3's kernel records
    (their launches come from the main path's run)."""
    from freerl_tpu_torch.envs import step_auto_reset
    from freerl_tpu_torch.envs.bipedal import BipedalWalker
    from freerl_tpu_torch.ops import bipedal as kern

    class Plain(BipedalWalker):
        """The walker whose step and reset are the plain version on any
        device."""

        def step(self, state, action, step_draw=None):
            return self._step_ref(state, action)

        def reset(self, draw):
            return self._reset_ref(draw)

    cpu, card, plain = (BipedalWalker("cpu"), BipedalWalker("cuda"),
                        Plain("cuda"))
    reset_err, reset_card_err = 0.0, 0.0
    for n in WALKER_RESET_CHECKS:
        draw = cpu.draw_reset(n, torch.Generator().manual_seed(n))
        got = card.reset(draw.cuda())
        want = cpu.reset(draw)
        if not torch.equal(got[0].terrain.cpu(), want[0].terrain):
            raise AssertionError(f"bipedal_reset on {n} rows: terrain "
                                 f"differs from the plain version's on the "
                                 f"CPU")
        a, c = walker_rows(want), walker_rows(got).cpu()
        err = float((a - c).abs().max())
        if not bool(((a - c).abs() <= 2e-5 + 1e-5 * a.abs()).all()):
            raise AssertionError(f"bipedal_reset on {n} rows against the "
                                 f"plain version: max abs err {err}")
        reset_err = max(reset_err, err)
        reset_card_err = max(reset_card_err, float(
            (walker_rows(plain.reset(draw.cuda()))
             - walker_rows(got)).abs().max()))

    steps, step_err, parts = 100, 0.0, []
    for b in WALKER_STEP_CHECKS:
        stiff, worst, flips = walker_teacher_forced(cpu, card, plain, b,
                                                    steps)
        if (stiff > 0.005 * b * steps or worst > 5e-3
                or flips > 0.001 * b * steps):
            raise AssertionError(
                f"bipedal_step on {b} envs against the plain version: "
                f"{stiff} stiff row-steps (worst {worst}), {flips} done "
                f"flags differ")
        step_err = max(step_err, worst)
        parts.append(f"{b} envs {stiff} of {b * steps} row-steps past "
                     f"rtol 1e-5 / atol 2e-5 (worst {worst:.3e}), {flips} "
                     f"done flags differ")
    log(f"[bipedal kernel] K3 == the plain version on the CPU on "
        f"{' / '.join(map(str, WALKER_RESET_CHECKS))} rows (terrain "
        f"bit-equal, max abs err {reset_err:.3e}; against the plain version "
        f"on the card {reset_card_err:.3e}); K2 through step_auto_reset, "
        f"{steps} teacher-forced steps against the plain version on the "
        f"card: {'; '.join(parts)}")

    # times at each env count
    times = {}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for n in WALKER_BATCHES:
        st, obs = card.reset(card.draw_reset(n, gen))
        act = torch.rand(n, 4, generator=gen, device="cuda") * 2.0 - 1.0
        rdraw = card.draw_reset(n, gen)
        _, obs1, *_ = card.step(st, act)
        rec = dict(
            k2_ms=device_ms(lambda: card.step(st, act)),
            k3_ms=device_ms(lambda: card.reset(rdraw)),
            floor_ms=device_ms(kern.floor_launcher(n)),
            k2_plain_ms=device_ms(lambda: plain.step(st, act), calls=2,
                                  replays=3),
            k3_plain_ms=device_ms(lambda: plain.reset(rdraw), calls=1,
                                  replays=3),
            vector_step_ms=eager_ms(
                lambda: step_auto_reset(card, st, act, None, rdraw), 100),
            plain_vector_step_ms=eager_ms(
                lambda: step_auto_reset(plain, st, act, None, rdraw), 3))
        for name, env in (("kernels", card), ("plain", plain)):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                step_auto_reset(env, st, act, None, rdraw)
                torch.cuda.synchronize()
            rec[f"{name}_launches"] = len(device_kernels(prof))
        rec["terrain_reads"] = walker_terrain_reads(st, act)
        rec["k2_bound"] = walker_bound(
            walker_step_bytes(n, rec["terrain_reads"]),
            n * kern.STEP_OPS + kern.LIDAR_SAMPLE_OPS * lidar_samples(obs1))
        rec["k3_bound"] = walker_bound(
            walker_reset_bytes(n),
            n * kern.RESET_OPS + kern.LIDAR_SAMPLE_OPS * lidar_samples(obs))
        times[n] = rec
        log(f"[bipedal kernel] {n} envs: K2 {rec['k2_ms']:.6f} ms, K3 "
            f"{rec['k3_ms']:.6f} ms (device, graph; bounds "
            f"{rec['k2_bound'][0]:.7f} ms by {rec['k2_bound'][1]}, K2 "
            f"reading {rec['terrain_reads'] / n:.1f} terrain floats a row, "
            f"/ {rec['k3_bound'][0]:.7f} ms by {rec['k3_bound'][1]}), "
            f"empty-kernel floor "
            f"{rec['floor_ms']:.6f} ms; plain version K2 "
            f"{rec['k2_plain_ms']:.4f} ms, K3 {rec['k3_plain_ms']:.4f} ms; "
            f"step_auto_reset as the loops call it {rec['vector_step_ms']:.4f} "
            f"ms with the kernels ({rec['kernels_launches']} kernels), "
            f"{rec['plain_vector_step_ms']:.4f} ms with the plain version "
            f"({rec['plain_launches']} kernels)")
    main = times[WALKER_BATCHES[0]]
    common = dict(route="cuda", source="freerl_tpu_torch/csrc/bipedal_step.cu",
                  library_ms=None, batch=WALKER_BATCHES[0],
                  floor_ms=main["floor_ms"], times=times)
    return [
        dict(name="bipedal_step", replaces="freerl_tpu/envs/bipedal.py:287",
             max_abs_err=step_err, ms=main["k2_ms"],
             plain_ms=main["k2_plain_ms"], bound_ms=main["k2_bound"][0],
             bound_by=main["k2_bound"][1], **common),
        dict(name="bipedal_reset", replaces="freerl_tpu/envs/bipedal.py:185",
             max_abs_err=reset_err, ms=main["k3_ms"],
             plain_ms=main["k3_plain_ms"], bound_ms=main["k3_bound"][0],
             bound_by=main["k3_bound"][1], **common)]


# ---------------------------------------------------------------------------
def phase_card_vs_cpu():
    """The port on the card against the port on the CPU, same inputs."""
    from freerl_tpu_torch.algos import DQN, DQNConfig
    from freerl_tpu_torch.buffers import PERBuffer
    from freerl_tpu_torch.core.types import Transition
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.envs.lunar_lander import HELIPAD_Y, LEG_DOWN

    rng = np.random.RandomState(0)
    devs = ("cpu", "cuda")

    def on(dev, x):
        return torch.as_tensor(x).to(dev)

    # LunarLander: a 20-step free-flight rollout, and one step from states
    # near the ground (contacts, friction, projection, crash, sleep)
    b = 256
    f = (rng.rand(b, 2).astype(np.float32) * 2000 - 1000)
    acts = rng.randint(0, 4, (20, b))
    disps = ((rng.rand(20, b, 2) * 2 - 1) / 30.0).astype(np.float32)
    outs = {}
    for dev in devs:
        env = make("LunarLander-v2", device=dev)
        s, o = env.reset(on(dev, f))
        seq = [o]
        for t in range(20):
            s, o, r, term, trunc = env.step(s, on(dev, acts[t]),
                                            on(dev, disps[t]))
            seq += [o, r[:, None]]
        outs[dev] = torch.cat(seq, 1).cpu()
    err = float((outs["cpu"] - outs["cuda"]).abs().max())
    if not torch.allclose(outs["cpu"], outs["cuda"], rtol=1e-4, atol=1e-3):
        raise AssertionError(f"LunarLander rollout card vs CPU: {err}")
    near = {
        "x": 10.0 + rng.randn(b), "y": HELIPAD_Y + LEG_DOWN + 0.05 * rng.randn(b),
        "vx": 0.5 * rng.randn(b), "vy": -rng.rand(b) * 2,
        "angle": 0.2 * rng.randn(b), "omega": 0.3 * rng.randn(b),
        "leg1": (rng.rand(b) < 0.5), "leg2": (rng.rand(b) < 0.5),
        "prev_shaping": -50 * rng.rand(b), "rest_time": 0.5 * rng.rand(b),
    }
    steps = {}
    for dev in devs:
        env = make("LunarLander-v2", device=dev)
        s, _ = env.reset(on(dev, f))
        for k, v in near.items():
            setattr(s, k, on(dev, np.asarray(v, np.float32)))
        s, o, r, term, trunc = env.step(s, on(dev, acts[0]), on(dev, disps[0]))
        steps[dev] = (torch.cat([o, r[:, None]], 1).cpu(), term.cpu())
    if not torch.allclose(steps["cpu"][0], steps["cuda"][0], rtol=1e-4,
                          atol=1e-3):
        raise AssertionError("LunarLander contact step card vs CPU")
    term_same = float((steps["cpu"][1] == steps["cuda"][1]).float().mean())
    if term_same < 0.99:
        raise AssertionError(f"terminations agree on {term_same:.3f} only")

    # DQN: five updates from the same params and batch
    n = 64
    batch_np = dict(
        obs=rng.randn(n, 8).astype(np.float32),
        action=rng.randint(0, 4, n).astype(np.int32),
        reward=rng.randn(n).astype(np.float32),
        next_obs=rng.randn(n, 8).astype(np.float32),
        done=rng.rand(n) < 0.1, episode_done=rng.rand(n) < 0.1,
    )
    w = rng.rand(n).astype(np.float32)
    cfg = DQNConfig(hidden=(128,))
    init = DQN(make("LunarLander-v2", device="cpu").dim_info, cfg,
               device="cpu").init(torch.Generator().manual_seed(0))
    params = {}
    for dev in devs:
        algo = DQN(make("LunarLander-v2", device=dev).dim_info, cfg, device=dev)
        st = algo.init(torch.Generator(device=dev).manual_seed(0))
        st.net.load_state_dict(init.net.state_dict())
        st.target_net.load_state_dict(init.net.state_dict())
        batch = Transition(**{k: on(dev, v) for k, v in batch_np.items()})
        for _ in range(5):
            st, _, prio = algo.update(st, batch, None, on(dev, w))
        params[dev] = torch.cat(
            [p.detach().flatten().cpu() for p in st.net.parameters()]
            + [p.flatten().cpu() for p in st.target_net.parameters()]
            + [prio.cpu()])
    err = float((params["cpu"] - params["cuda"]).abs().max())
    if err > 1e-5:
        raise AssertionError(f"DQN updates card vs CPU: max abs err {err}")

    # PER buffer: adds, a priority write with duplicate indices, a draw
    ex = Transition(**{k: torch.as_tensor(v[0]) for k, v in batch_np.items()})
    idx_np = rng.randint(0, 2048, 512)
    idx_np[::7] = idx_np[0]                      # many duplicates
    td = rng.randn(512).astype(np.float32)
    r = rng.rand(256).astype(np.float32)
    res = {}
    for dev in devs:
        buf = PERBuffer.create(4096, ex.map(lambda x: x.to(dev)),
                               sampler="tree")
        for i in range(8):
            buf.add(Transition(**{
                k: on(dev, np.roll(v, i, axis=0)).repeat_interleave(4, 0)
                for k, v in batch_np.items()}))
        buf.update_priorities(on(dev, idx_np), on(dev, td))
        idx, w_is = buf.sample_idx(on(dev, r))
        res[dev] = (buf.tree.cpu(), idx.cpu(), w_is.cpu())
    # pow(x, 0.5) may round one ulp apart on the two devices, so the tree
    # agrees to f32 rounding, and a draw on a node boundary may step a leaf
    if not torch.allclose(res["cpu"][0], res["cuda"][0], rtol=1e-6):
        raise AssertionError("PER tree card vs CPU differs")
    same = res["cpu"][1] == res["cuda"][1]
    if float(same.float().mean()) < 0.99:
        raise AssertionError("PER sampled idx card vs CPU differs")
    if not torch.allclose(res["cpu"][2][same], res["cuda"][2][same],
                          rtol=1e-5):
        raise AssertionError("PER IS weights card vs CPU differ")
    log(f"[card-vs-cpu] LunarLander rollout + contact step, 5 DQN updates "
        f"(max abs err {err:.2e}), PER tree/idx/weights: ok")


# ---------------------------------------------------------------------------
RAINBOW = dict(double=True, dueling=True, per=True, per_sampler="tree",
               noisy=True, n_step=3, categorical=True)


def to_device(x, dev):
    """A tensor, or a dataclass / list / tuple / dict of tensors, on
    ``dev``."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    return type(x)(**{f.name: to_device(getattr(x, f.name), dev)
                      for f in dataclasses.fields(x)})


def phase_card_vs_cpu_family():
    """The trick matrix and the discrete envs on the card against the CPU,
    from identical inputs and draws."""
    import copy

    from freerl_tpu_torch.algos import DQN, DQNConfig
    from freerl_tpu_torch.algos.common import c51_project
    from freerl_tpu_torch.buffers import ReplayBuffer
    from freerl_tpu_torch.buffers.nstep import nstep_fold
    from freerl_tpu_torch.core.types import DimInfo, Transition
    from freerl_tpu_torch.envs import make, step_auto_reset, vec_reset

    rng = np.random.RandomState(1)
    devs = ("cpu", "cuda")
    errs = {}

    def on(dev, x):
        return torch.as_tensor(x).to(dev)

    def worst(name, got, tol):
        err = float((got["cpu"].double() - got["cuda"].double().cpu())
                    .abs().max())
        errs[name] = err
        if not err <= tol:
            raise AssertionError(f"{name} card vs CPU: max abs err {err} "
                                 f"> {tol}")

    # c51_project at the main path's shape (B 256, 51 atoms), tz partly
    # outside [v_min, v_max]; the dense form has no atomics, so only the
    # rounding of the two devices' reductions may differ
    b, n = 256, 51
    atoms = np.linspace(-100, 100, n).astype(np.float32)
    logits = rng.randn(b, n)
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(
        np.float32)
    g = 0.99 ** rng.randint(1, 4, b) * (rng.rand(b) > 0.1)
    tz = ((rng.randn(b) * 40)[:, None] + g[:, None] * atoms).astype(np.float32)
    worst("c51_project", {dev: c51_project(on(dev, probs), on(dev, tz),
                                           on(dev, atoms)) for dev in devs},
          1e-6)

    # five Rainbow updates at full width from the same params, batch,
    # IS weights, eff_gamma and noise
    di, cfg = DimInfo(8, 4), DQNConfig(**RAINBOW)
    cpu_algo = DQN(di, cfg, device="cpu")
    init = cpu_algo.init(torch.Generator().manual_seed(0))
    bs = 256
    batch_np = dict(
        obs=rng.randn(bs, 8).astype(np.float32),
        action=rng.randint(0, 4, bs).astype(np.int32),
        reward=(rng.randn(bs) * 10).astype(np.float32),
        next_obs=rng.randn(bs, 8).astype(np.float32),
        done=rng.rand(bs) < 0.1, episode_done=rng.rand(bs) < 0.1,
    )
    w = rng.rand(bs).astype(np.float32)
    eff_gamma = (0.99 ** rng.randint(1, 4, bs)).astype(np.float32)
    noises = [cpu_algo.draw_update_noise(init, torch.Generator().manual_seed(i))
              for i in range(5)]
    params = {}
    for dev in devs:
        algo = DQN(di, cfg, device=dev)
        st = algo.init(torch.Generator(device=dev).manual_seed(0))
        st.net.load_state_dict(init.net.state_dict())
        st.target_net.load_state_dict(init.net.state_dict())
        batch = Transition(**{k: on(dev, v) for k, v in batch_np.items()})
        for noise in noises:
            st, _, prio = algo.update(st, batch, on(dev, eff_gamma),
                                      on(dev, w), to_device(noise, dev))
        params[dev] = torch.cat(
            [p.detach().flatten() for p in st.net.parameters()]
            + [p.flatten() for p in st.target_net.parameters()] + [prio])
    # the plain head's tolerance above; Adam's first steps scale every
    # gradient element to about lr, so a near-zero gradient can carry the
    # devices' matmul rounding further than the forward's
    worst("rainbow_updates", params, 1e-5)

    # the per-row noisy forward of exploration at 1024 rows
    x = rng.randn(1024, 8).astype(np.float32)
    rows = init.net.draw_noise(torch.Generator().manual_seed(9), rows=1024)
    nets = {"cpu": init.net, "cuda": copy.deepcopy(init.net).to("cuda")}
    with torch.no_grad():
        worst("noisy_forward_1024_rows",
              {dev: nets[dev](on(dev, x), to_device(rows, dev))
               for dev in devs}, 1e-5)

    # nstep_fold over a ring of 64 envs x 64 steps
    n_envs = 64
    ex = Transition(**{k: torch.as_tensor(v[0]) for k, v in batch_np.items()})
    ring_np = [{k: np.roll(v, 7 * i, axis=0)[:n_envs]
                for k, v in batch_np.items()} for i in range(64)]
    idx = rng.randint(0, 64 * n_envs, 256)
    folds = {}
    for dev in devs:
        ring = ReplayBuffer.create(64 * n_envs, to_device(ex, dev),
                                   add_batch=n_envs)
        for step in ring_np:
            ring.add(Transition(**{k: on(dev, v) for k, v in step.items()}))
        fold, eg = nstep_fold(ring.data, on(dev, idx), n_envs, 3, 0.99)
        folds[dev] = (fold, eg)
    for name in ("obs", "action", "next_obs", "done", "episode_done"):
        if not torch.equal(getattr(folds["cpu"][0], name),
                           getattr(folds["cuda"][0], name).cpu()):
            raise AssertionError(f"nstep_fold {name} card vs CPU")
    # returns reach about 60 in magnitude, where one f32 ulp is 3.8e-6:
    # pow and the three-term sum may round an ulp or two apart
    worst("nstep_fold_return", {d: f[0].reward for d, f in folds.items()},
          1e-5)
    worst("nstep_fold_eff_gamma", {d: f[1] for d, f in folds.items()}, 1e-6)

    # 200 auto-resetting steps of each classic and tabular env, 256 rows;
    # every step starts the card from the CPU's state and draws. cos/sin
    # round an ulp apart on the two devices: rtol 1e-5 / atol 1e-5 for the
    # classic envs, and a done flag may flip only on a threshold's ulp
    flips = 0
    for name in ("CartPole-v1", "MountainCar-v0", "MountainCarContinuous-v0",
                 "Pendulum-v1", "FrozenLake-v1", "Taxi-v3"):
        env = {dev: make(name, device=dev) for dev in devs}
        gen = torch.Generator().manual_seed(0)
        state, _ = vec_reset(env["cpu"], gen, 256)
        exact = name in ("FrozenLake-v1", "Taxi-v3")
        di = env["cpu"].dim_info
        for t in range(200):
            if di.is_continue:
                action = torch.rand(256, 1, generator=gen) * 3.0 - 1.5
            else:
                action = torch.randint(0, di.action_dim, (256,), generator=gen)
            draws = (env["cpu"].draw_step(256, gen),
                     env["cpu"].draw_reset(256, gen))
            out = {"cpu": step_auto_reset(env["cpu"], state, action, *draws)}
            out["cuda"] = step_auto_reset(
                env["cuda"], to_device(state, "cuda"), action.cuda(),
                *to_device(draws, "cuda"))
            same = out["cpu"].episode_done == out["cuda"].episode_done.cpu()
            flips += int((~same).sum())
            for field in ("next_obs", "carry_obs", "reward"):
                a = getattr(out["cpu"], field)[same]
                c = getattr(out["cuda"], field).cpu()[same]
                ok = (torch.equal(a, c) if exact
                      else torch.allclose(a, c, rtol=1e-5, atol=1e-5))
                if not ok:
                    raise AssertionError(
                        f"{name} step {t} {field} card vs CPU: "
                        f"{float((a - c).abs().max())}")
            state = out["cpu"].state
    if flips > 2:
        raise AssertionError(f"{flips} done flags differ card vs CPU")
    log(f"[card-vs-cpu] c51_project, 5 Rainbow updates, per-row noisy "
        f"forward (1024 rows), nstep_fold, 200 steps of 6 envs: ok; max abs "
        f"errs {json.dumps(errs)}; done flags that differ: {flips}")


# ---------------------------------------------------------------------------
# the nine variants of the JAX package's tests/test_continuous.py, at full
# width: (algo, config, continuous?)
CONTINUOUS_VARIANTS = {
    "ddpg": ("DDPG", dict(), True),
    "ddpg_full": ("DDPG", dict(weight_decay=True, ou_noise=True,
                               obs_norm=True, net_init=True, num_envs=1024),
                  True),
    "ddpg_popart": ("DDPG", dict(popart=True), True),
    "ddpg_disc": ("DDPG", dict(), False),
    "ddpg_disc_gumbel": ("DDPG", dict(discrete_gumbel=True), False),
    "td3": ("TD3", dict(), True),
    "td3_min": ("TD3", dict(clip_double=False, policy_noise=False,
                            twin_delay=False), True),
    "sac": ("SAC", dict(), True),
    "sac_disc": ("SAC", dict(), False),
}


def algo_classes(name: str):
    from freerl_tpu_torch import algos

    return getattr(algos, name), getattr(algos, name + "Config")


def phase_card_vs_cpu_continuous():
    """The continuous family on the card against the CPU: five updates of
    each variant at full width from identical params, batch and draws;
    200 auto-resetting steps of LunarLanderContinuous at 1024 envs;
    relabel_future on a 200-step rollout of 1024 envs."""
    from freerl_tpu_torch.core.types import DimInfo, Transition
    from freerl_tpu_torch.envs import make, step_auto_reset, vec_reset
    from freerl_tpu_torch.train import relabel_future

    rng = np.random.RandomState(2)
    devs = ("cpu", "cuda")
    errs = {}
    bs = 256
    for name, (algo_name, extra, cont) in CONTINUOUS_VARIANTS.items():
        cls, cfg_cls = algo_classes(algo_name)
        di = (DimInfo(8, 2, True, 1.0) if cont else DimInfo(8, 4))
        cfg = cfg_cls(batch_size=bs, **extra)
        cpu_algo = cls(di, cfg, device="cpu")
        init = cpu_algo.init(torch.Generator().manual_seed(0))
        if cont:
            action = rng.uniform(-1, 1, (bs, 2)).astype(np.float32)
        elif name == "ddpg_disc":           # the behaviour probs it stores
            action = rng.dirichlet(np.ones(4), bs).astype(np.float32)
        else:
            action = rng.randint(0, 4, bs).astype(np.int32)
        batch_np = dict(
            obs=rng.randn(bs, 8).astype(np.float32), action=action,
            reward=(rng.randn(bs) * 10).astype(np.float32),
            next_obs=rng.randn(bs, 8).astype(np.float32),
            done=rng.rand(bs) < 0.1, episode_done=rng.rand(bs) < 0.1)
        cpu_batch = Transition(**{k: torch.as_tensor(v)
                                  for k, v in batch_np.items()})
        gen = torch.Generator().manual_seed(1)
        draws = [cpu_algo.draw_update(cpu_batch, gen) for _ in range(5)]
        out = {}
        for dev in devs:
            algo = cls(di, cfg, device=dev)
            st = algo.init(torch.Generator(device=dev).manual_seed(0))
            for net in ("actor", "actor_target", "critic", "critic_target"):
                getattr(st, net).load_state_dict(getattr(init, net).state_dict())
            batch = to_device(cpu_batch, dev)
            losses = []
            for d in draws:
                st, m, _ = algo.update(st, batch, to_device(d, dev))
                losses += [m[k].reshape(1) for k in sorted(m)]
            vals = [p.detach().flatten() for net in (
                st.actor, st.actor_target, st.critic, st.critic_target)
                for p in net.parameters()]
            if algo_name == "SAC":
                vals.append(st.log_alpha.detach().reshape(1))
            if extra.get("popart"):
                vals += [st.popart.mean.reshape(1), st.popart.var.reshape(1)]
            out[dev] = (torch.cat(vals).cpu().double(),
                        torch.cat(losses).cpu().double())
        err = float((out["cpu"][0] - out["cuda"][0]).abs().max())
        loss_err = float(((out["cpu"][1] - out["cuda"][1]).abs()
                          / out["cpu"][1].abs().clamp(min=1.0)).max())
        errs[name] = (err, loss_err)
        # the DQN updates' tolerance for the learner state (float32 matmul
        # and Adam rounding); the losses reach ~200 here, where one f32 ulp
        # is 1.5e-5, so they are held relatively, to a few ulps
        if not (err <= 1e-5 and loss_err <= 1e-6):
            raise AssertionError(f"{name} updates card vs CPU: max abs err "
                                 f"{err}, losses' max rel err {loss_err}")

    # 200 auto-resetting steps of LunarLanderContinuous, 1024 rows; every
    # step starts the card from the CPU's state and draws
    env = {dev: make("LunarLanderContinuous-v2", device=dev) for dev in devs}
    gen = torch.Generator().manual_seed(0)
    state, _ = vec_reset(env["cpu"], gen, 1024)
    flips, worst = 0, 0.0
    for step in range(200):
        action = torch.rand(1024, 2, generator=gen) * 3.0 - 1.5
        draws = (env["cpu"].draw_step(1024, gen),
                 env["cpu"].draw_reset(1024, gen))
        cpu = step_auto_reset(env["cpu"], state, action, *draws)
        card = step_auto_reset(env["cuda"], to_device(state, "cuda"),
                               action.cuda(), *to_device(draws, "cuda"))
        same = cpu.episode_done == card.episode_done.cpu()
        flips += int((~same).sum())
        for field in ("next_obs", "carry_obs", "reward"):
            a = getattr(cpu, field)[same]
            c = getattr(card, field).cpu()[same]
            worst = max(worst, float((a - c).abs().max()))
            if not torch.allclose(a, c, rtol=1e-4, atol=1e-3):
                raise AssertionError(f"LunarLanderContinuous step {step} "
                                     f"{field} card vs CPU")
        state = cpu.state
    if flips > 0.001 * 200 * 1024:
        raise AssertionError(f"{flips} done flags differ card vs CPU")

    # relabel_future: 1024 trajectories of 200 steps, 4 goals each
    genv = {dev: make("GoalPendulum-v1", device=dev) for dev in devs}
    roll = dict(obs=rng.randn(1024, 200, 6), action=rng.randn(1024, 200, 1),
                next_obs=rng.randn(1024, 200, 6), u=rng.rand(1024, 200, 4))
    roll = {k: torch.from_numpy(v.astype(np.float32)) for k, v in roll.items()}
    rel = {dev: relabel_future(genv[dev], *[roll[k].to(dev) for k in (
        "obs", "action", "next_obs", "u")], 200) for dev in devs}
    for field in ("obs", "action", "next_obs", "done"):
        if not torch.equal(getattr(rel["cpu"], field),
                           getattr(rel["cuda"], field).cpu()):
            raise AssertionError(f"relabel_future {field} card vs CPU")
    # the sparse reward thresholds a float cost: a flip needs a cost within
    # an ulp of the tolerance
    reward_flips = int((rel["cpu"].reward != rel["cuda"].reward.cpu()).sum())
    if reward_flips > 2:
        raise AssertionError(f"relabel_future: {reward_flips} rewards differ")
    log(f"[card-vs-cpu continuous] 5 updates of 9 variants at full width, "
        f"batch {bs}: (state max abs err, losses max rel err) "
        f"{json.dumps(errs)}; LunarLanderContinuous "
        f"200 steps x 1024: max abs err {worst:.2e}, done flags that differ "
        f"{flips}; relabel_future 1024 x 200 x 4 = {rel['cpu'].obs.shape[0]} "
        f"rows: equal, rewards that differ {reward_flips}")


# ---------------------------------------------------------------------------
def probe(algo_cls):
    """``algo_cls`` keeping each learner step's metrics, its CUDA events and
    the buffer, for the checks after the run (no device sync)."""
    class Probe(algo_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.metrics, self.events, self.buffer = [], [], None

        def learn_step(self, state, buffer, generator, num_envs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, buffer, metrics = super().learn_step(
                state, buffer, generator, num_envs)
            end.record()
            self.events.append((start, end))
            self.metrics.append(metrics)
            self.buffer = buffer
            return state, buffer, metrics

    return Probe


LOSSES = ("loss", "critic_loss", "actor_loss", "alpha", "adv_mean",
          "factor_mean")


def check_metrics(label: str, algo) -> list:
    """Every reported loss of every learner step (the multi-agent family's
    per agent, ``critic_loss_0``, ...) is finite; returns the names
    checked."""
    names = [k for k in (algo.metrics[0] if algo.metrics else ())
             if k.rstrip("_0123456789") in LOSSES]
    for k in names:
        if not bool(torch.isfinite(torch.stack(
                [m[k] for m in algo.metrics])).all()):
            raise AssertionError(f"{label}: non-finite {k}")
    return names


def run_probed(run, env, algo, label: str):
    """``run()`` (a user entry point) on the card with the sum-tree
    kernel's count set to 0 just before and read just after; the common
    numbers the phases print."""
    from freerl_tpu_torch.ops import sumtree

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sumtree.launches = 0
    _, returns, info = run()
    launches = sumtree.launches
    torch.cuda.synchronize()
    checked = check_metrics(label, algo)
    if not np.isfinite(returns).all():
        raise AssertionError(f"{label}: non-finite episode return")
    return dict(
        env=env, algo=algo, returns=returns, info=info, launches=launches,
        checked=checked,
        peak_mib=torch.cuda.max_memory_allocated() / 2**20,
        learn_ms=float(np.mean([s.elapsed_time(e) for s, e in algo.events]))
        if algo.events else float("nan"))


def drive(env_name: str, algo_cfg, loop_cfg, dis_to_con: bool = False,
          algo_cls=None):
    """train_offpolicy on the card through the user's entry points (DQN
    unless ``algo_cls`` says otherwise). Checks finite losses and a
    consistent episode record; returns what the phases check and print."""
    from freerl_tpu_torch.algos import DQN
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.train import train_offpolicy

    env = make(env_name, dis_to_con=dis_to_con, device="cuda")
    algo = probe(algo_cls or DQN)(env.dim_info, algo_cfg, device="cuda")
    label = f"{env.name} {algo_cfg}"
    r = run_probed(lambda: train_offpolicy(env, algo, loop_cfg), env, algo,
                   label)
    info, returns = r["info"], r["returns"]
    if len(algo.metrics) != info["updates"]:
        raise AssertionError(f"{label}: {len(algo.metrics)} metrics for "
                             f"{info['updates']} learner steps")
    if len(returns) != min(info["episodes"], loop_cfg.max_episodes):
        raise AssertionError(f"{label}: episode record {len(returns)} for "
                             f"{info}")
    return r


def phase_main_path(label: str, **tricks) -> int:
    """DQN on LunarLander-v2 at full width, 1024 envs, 256 vector steps."""
    from freerl_tpu_torch.algos import DQNConfig
    from freerl_tpu_torch.train import OffPolicyConfig

    num_envs, chunk = 1024, 64
    cfg = OffPolicyConfig(seed=0, num_envs=num_envs, start_steps=500,
                          updates_per_burst=1, chunk_size=chunk,
                          max_env_steps=num_envs * chunk * 4,
                          max_episodes=10**9)
    dqn = DQNConfig(buffer_size=1_000_000, batch_size=256, hidden=(128,),
                    **{"per_sampler": "tree", **tricks})
    r = drive("LunarLander-v2", dqn, cfg)
    info, launches, returns = r["info"], r["launches"], r["returns"]
    if info["updates"] < 200:
        raise AssertionError(f"{label}: {info['updates']} learner steps")
    if info["episodes"] <= 0:
        raise AssertionError(f"{label}: no episode finished")
    if dqn.per:
        if launches != info["updates"]:
            raise AssertionError(
                f"{label}: sumtree kernel launched {launches} times for "
                f"{info['updates']} learner steps")
        buf = r["algo"].buffer
        root = float(buf.tree[1])
        leaves = float(buf.tree[buf.capacity:].double().sum())
        if abs(root - leaves) > 1e-4 * abs(leaves):
            raise AssertionError(f"PER root {root} != sum of leaves {leaves}")
    elif launches != 0:
        raise AssertionError("uniform replay launched the sum-tree kernel")
    log(f"[main {label}] {info['env_steps']} env steps, {info['updates']} "
        f"learner steps, {info['episodes']} episodes (mean return "
        f"{returns.mean():.1f}) in {info['elapsed_s']:.2f} s: "
        f"{info['env_steps_per_s']:.0f} env-steps/s, learner step "
        f"{r['learn_ms']:.3f} ms, peak memory {r['peak_mib']:.1f} MiB, "
        f"sumtree launches {launches}")
    return launches


# the range one episode's return can take in each env of the family, as
# DQN sees it; an untrained MountainCar episode is truncated at -200
FAMILY = {
    "CartPole-v1": (1.0, 500.0),
    "MountainCar-v0": (-200.0, -200.0),
    "FrozenLake-v1": (0.0, 1.0),
    "Taxi-v3": (-2000.0, 20.0),
    "Pendulum-v1": (-200 * (np.pi ** 2 + 6.4 + 0.004), 0.0),
    "MountainCarContinuous-v0": (-0.1 * 999, 100.0),
}


def phase_family():
    from freerl_tpu_torch.algos import DQNConfig
    from freerl_tpu_torch.train import OffPolicyConfig

    num_envs, chunk, chunks = 1024, 32, 7          # 224 > 200 steps
    cfg = OffPolicyConfig(seed=0, num_envs=num_envs, start_steps=500,
                          chunk_size=chunk, max_env_steps=num_envs * chunk
                          * chunks, max_episodes=10**9, host_sync_every=1)
    dqn = DQNConfig(double=True, dueling=True, n_step=3)
    for name, (lo, hi) in FAMILY.items():
        r = drive(name, dqn, cfg, dis_to_con=True)
        info, returns = r["info"], r["returns"]
        want = sum(1 for t in range(1, chunk * chunks + 1)
                   if t * num_envs > cfg.start_steps)
        if r["launches"] != 0 or info["updates"] != want:
            raise AssertionError(f"{name}: {r['launches']} sum-tree launches, "
                                 f"{info['updates']} learner steps")
        if name != "MountainCarContinuous-v0" and len(returns) < num_envs:
            raise AssertionError(f"{name}: only {len(returns)} episodes")
        if len(returns) and not (returns.min() >= lo - 1e-3
                                 and returns.max() <= hi + 1e-3):
            raise AssertionError(f"{name}: returns in [{returns.min()}, "
                                 f"{returns.max()}], outside [{lo}, {hi}]")
        log(f"[family {r['env'].name}] {info['env_steps']} env steps, "
            f"{info['updates']} learner steps, {info['episodes']} episodes "
            f"(returns {returns.min() if len(returns) else 'none'} .. "
            f"{returns.max() if len(returns) else 'none'}) in "
            f"{info['elapsed_s']:.2f} s: {info['env_steps_per_s']:.0f} "
            f"env-steps/s, learner step {r['learn_ms']:.3f} ms")


def phase_continuous(algo_name: str) -> dict:
    """DDPG, TD3 or SAC on LunarLanderContinuous-v2 at full width (the
    config's defaults: hidden (128, 128), replay 1e6), batch 256, 1024
    envs, 256 vector steps, one update per vector step."""
    from freerl_tpu_torch.train import OffPolicyConfig

    num_envs, chunk = 1024, 64
    cls, cfg_cls = algo_classes(algo_name)
    cfg = OffPolicyConfig(seed=0, num_envs=num_envs, start_steps=500,
                          updates_per_burst=1, chunk_size=chunk,
                          max_env_steps=num_envs * chunk * 4,
                          max_episodes=10**9)
    algo_cfg = cfg_cls(batch_size=256, num_envs=num_envs)
    r = drive("LunarLanderContinuous-v2", algo_cfg, cfg, algo_cls=cls)
    info, returns, buf = r["info"], r["returns"], r["algo"].buffer
    label = f"continuous {algo_name}"
    if info["updates"] != 256 or r["launches"] != 0:
        raise AssertionError(f"{label}: {info['updates']} learner steps, "
                             f"{r['launches']} sum-tree launches")
    # no lower bound: the shaping term charges an unwrapped hull angle
    if info["episodes"] <= 0 or not returns.max() <= 400:
        raise AssertionError(f"{label}: {info['episodes']} episodes, "
                             f"returns {returns.min()} .. {returns.max()}")
    max_abs = float(buf.data.action[:buf.size].abs().max())
    if max_abs > r["env"].dim_info.max_action:
        raise AssertionError(f"{label}: stored action {max_abs} out of range")
    log(f"[continuous {algo_name}] {info['env_steps']} env steps, "
        f"{info['updates']} learner steps, {info['episodes']} episodes (mean "
        f"return {returns.mean():.1f}) in {info['elapsed_s']:.2f} s: "
        f"{info['env_steps_per_s']:.0f} env-steps/s, learner step "
        f"{r['learn_ms']:.3f} ms, peak memory {r['peak_mib']:.1f} MiB, max "
        f"|action| {max_abs:.4f}, finite {r['checked']}, sumtree launches "
        f"{r['launches']}")
    return dict(env_steps_per_s=info["env_steps_per_s"],
                learn_ms=r["learn_ms"], peak_mib=r["peak_mib"],
                launches=r["launches"])


def phase_discrete_actor_critic() -> int:
    """Discrete DDPG (softmax and Gumbel actors, through explore_stored)
    and discrete SAC on CartPole-v1: 1024 envs, 224 vector steps."""
    from freerl_tpu_torch.train import OffPolicyConfig

    num_envs, chunk, chunks = 1024, 32, 7
    cfg = OffPolicyConfig(seed=0, num_envs=num_envs, start_steps=500,
                          chunk_size=chunk, max_env_steps=num_envs * chunk
                          * chunks, max_episodes=10**9, host_sync_every=1)
    launches = 0
    for label, algo_name, extra in (
            ("DDPG softmax", "DDPG", dict()),
            ("DDPG gumbel", "DDPG", dict(discrete_gumbel=True)),
            ("SAC", "SAC", dict())):
        cls, cfg_cls = algo_classes(algo_name)
        r = drive("CartPole-v1", cfg_cls(batch_size=256, **extra), cfg,
                  algo_cls=cls)
        info, returns, buf = r["info"], r["returns"], r["algo"].buffer
        launches += r["launches"]
        action = buf.data.action[:buf.size]
        if algo_name == "DDPG":
            stored_ok = bool(((action.sum(1) - 1).abs() < 1e-4).all())
        else:
            stored_ok = action.dim() == 1 and action.dtype == torch.int32
        if (info["updates"] != chunk * chunks or r["launches"] != 0
                or len(returns) < num_envs or not stored_ok
                or not (returns.min() >= 1 and returns.max() <= 500)):
            raise AssertionError(f"CartPole {label}: {info}, sum-tree "
                                 f"launches {r['launches']}, stored actions "
                                 f"ok {stored_ok}")
        log(f"[discrete CartPole-v1 {label}] {info['env_steps']} env steps, "
            f"{info['updates']} learner steps, {info['episodes']} episodes "
            f"(returns {returns.min()} .. {returns.max()}) in "
            f"{info['elapsed_s']:.2f} s: {info['env_steps_per_s']:.0f} "
            f"env-steps/s, learner step {r['learn_ms']:.3f} ms, peak memory "
            f"{r['peak_mib']:.1f} MiB, stored action {tuple(action.shape[1:])} "
            f"{action.dtype}")
    return launches


def phase_her() -> int:
    """train_her with DDPG on GoalPendulum-v1: 1024 envs, two episodes of
    200 steps, 200 updates per episode."""
    from freerl_tpu_torch.algos import DDPG, DDPGConfig
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.train import HERConfig, train_her

    env = make("GoalPendulum-v1", device="cuda")
    algo = probe(DDPG)(env.dim_info, DDPGConfig(batch_size=256),
                       device="cuda")
    cfg = HERConfig(num_envs=1024, max_episodes=2048, updates_per_episode=200)
    r = run_probed(lambda: train_her(env, algo, cfg), env, algo, "HER")
    info, returns = r["info"], r["returns"]
    if (len(returns) != 2048 or len(algo.metrics) != 400 or r["launches"]
            or not (returns.min() >= -200 and returns.max() <= 0)):
        raise AssertionError(f"HER: {info}, {len(algo.metrics)} learner "
                             f"steps, returns {returns.min()} .. "
                             f"{returns.max()}")
    log(f"[her GoalPendulum-v1] {info['env_steps']} env steps, "
        f"{len(algo.metrics)} learner steps, {info['episodes']} episodes "
        f"(returns {returns.min()} .. {returns.max()}, mean "
        f"{returns.mean():.1f}) in {info['elapsed_s']:.2f} s: "
        f"{info['env_steps'] / info['elapsed_s']:.0f} env-steps/s, learner "
        f"step {r['learn_ms']:.3f} ms, peak memory {r['peak_mib']:.1f} MiB, "
        f"ring {r['algo'].buffer.size} rows")
    return r["launches"]


# ---------------------------------------------------------------------------
def phase_card_vs_cpu_onpolicy():
    """The on-policy slice on the card against the CPU, from identical
    inputs and draws: ``gae``; one full PPO update of each branch at full
    width (2x128); one REINFORCE update; 100 teacher-forced auto-resetting
    steps of BipedalWalker at 256 envs."""
    from freerl_tpu_torch.algos import (PPO, REINFORCE, PPOConfig,
                                        REINFORCEConfig, Rollout)
    from freerl_tpu_torch.algos.common import gae
    from freerl_tpu_torch.envs import make, step_auto_reset, vec_reset

    rng = np.random.RandomState(3)
    devs = ("cpu", "cuda")
    errs = {}

    def on(dev, x):
        return torch.as_tensor(x).to(dev)

    def rel_err(got):
        a, b = got["cpu"].double(), got["cuda"].double().cpu()
        return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())

    # gae over a (64, 1024) rollout: the tests' float32 tolerance, relative
    t, n = 64, 1024
    ins = [rng.randn(t, n).astype(np.float32) for _ in range(3)]
    dead = rng.rand(t, n) < 0.02
    ends = dead | (rng.rand(t, n) < 0.02)
    errs["gae"] = rel_err({dev: torch.cat(gae(
        *[on(dev, x) for x in ins], on(dev, dead), on(dev, ends), 0.99, 0.95))
        for dev in devs})
    if errs["gae"] > 1e-5:
        raise AssertionError(f"gae card vs CPU: {errs['gae']}")

    # one full update per PPO branch at full width: T 16, N 16, minibatch
    # 64, 10 epochs (40 Adam steps, as in the tests), same params,
    # rollout, permutations and episode count on both devices
    walker = make("BipedalWalker-v3", device="cpu").dim_info
    cartpole = make("CartPole-v1", device="cpu").dim_info
    t, n = 16, 16
    branches = {
        "gauss": (walker, dict(), None),
        "discrete": (cartpole, dict(), None),
        "beta": (walker, dict(beta_dist=True), None),
        "all_tricks": (walker, dict(adv_norm=True, obs_norm=True,
                                    reward_scaling=True, lr_decay=True,
                                    orthogonal_init=True, adam_eps=True,
                                    tanh=True, num_envs=n), 10),
        "recompute_logp": (walker, dict(recompute_logp=True), None),
        "std_decay": (walker, dict(std_decay=True), 50),
    }
    for name, (di, extra, episodes) in branches.items():
        cfg = PPOConfig(horizon=t * n, num_envs=extra.pop("num_envs", 1),
                        **extra)
        if not di.is_continue:
            action = rng.randint(0, di.action_dim, (t, n))
        elif cfg.beta_dist:
            action = rng.uniform(0.02, 0.98, (t, n, di.action_dim))
        else:
            action = rng.uniform(-1, 1, (t, n, di.action_dim))
        done = rng.rand(t, n) < 0.05
        roll_np = dict(
            obs=rng.randn(t, n, di.obs_dim).astype(np.float32),
            action=action.astype(np.int64 if not di.is_continue
                                 else np.float32),
            log_pi=(rng.randn(t, n) * 0.1 - 1.0).astype(np.float32),
            reward=rng.randn(t, n).astype(np.float32),
            next_obs=rng.randn(t, n, di.obs_dim).astype(np.float32),
            done=done, adv_done=done | (rng.rand(t, n) < 0.05))
        cpu_algo = PPO(di, cfg, device="cpu")
        init = cpu_algo.init(torch.Generator().manual_seed(0))
        cpu_roll = Rollout(**{k: torch.as_tensor(v)
                              for k, v in roll_np.items()})
        perms = cpu_algo.draw_update(cpu_roll, torch.Generator().manual_seed(1))
        out = {}
        for dev in devs:
            algo = PPO(di, cfg, device=dev)
            st = algo.init(torch.Generator(device=dev).manual_seed(0))
            st.actor.load_state_dict(init.actor.state_dict())
            st.critic.load_state_dict(init.critic.state_dict())
            st, m = algo.update(
                st, to_device(cpu_roll, dev), perms.to(dev),
                None if episodes is None else torch.tensor(episodes,
                                                           device=dev))
            out[dev] = torch.cat(
                [p.detach().flatten() for p in st.actor.parameters()]
                + [p.detach().flatten() for p in st.critic.parameters()]
                + [st.ext_std.reshape(1), m["adv_mean"].reshape(1)]).cpu()
        err = float((out["cpu"] - out["cuda"]).abs().max())
        errs[f"ppo_{name}"] = err
        if not err <= 1e-5:
            raise AssertionError(f"PPO {name} update card vs CPU: max abs "
                                 f"err {err}")

    # one REINFORCE update at its full width (128 hidden), T 64, N 16
    t, n = 64, 16
    ends = rng.rand(t, n) < 0.05
    roll_np = dict(
        obs=rng.randn(t, n, 4).astype(np.float32),
        action=rng.randint(0, 2, (t, n)), log_pi=np.zeros((t, n), np.float32),
        reward=np.ones((t, n), np.float32),
        next_obs=rng.randn(t, n, 4).astype(np.float32),
        done=ends, adv_done=ends)
    init = REINFORCE(cartpole, device="cpu").init(
        torch.Generator().manual_seed(0))
    out = {}
    for dev in devs:
        algo = REINFORCE(cartpole, REINFORCEConfig(), device=dev)
        st = algo.init(torch.Generator(device=dev).manual_seed(0))
        st.policy.load_state_dict(init.policy.state_dict())
        st, m = algo.update(st, Rollout(**{k: on(dev, v)
                                           for k, v in roll_np.items()}))
        out[dev] = (torch.cat([p.detach().flatten().cpu()
                               for p in st.policy.parameters()]),
                    adam_steps(st.opt))
    errs["reinforce"] = float((out["cpu"][0] - out["cuda"][0]).abs().max())
    if errs["reinforce"] > 1e-5 or out["cpu"][1] != out["cuda"][1]:
        raise AssertionError(f"REINFORCE update card vs CPU: "
                             f"{errs['reinforce']}, Adam steps "
                             f"{out['cpu'][1]} / {out['cuda'][1]}")

    # BipedalWalker: 100 auto-resetting steps of 256 envs, the card's step
    # from the CPU's state with the CPU's draws each time. The tests'
    # tolerance (rtol 1e-5 / atol 2e-5) on every row; a stiff step (a
    # crash) may amplify rounding, so up to 0.5% of the row-steps may
    # differ by up to 5e-3, and 0.1% of the done flags may flip
    env = {dev: make("BipedalWalker-v3", device=dev) for dev in devs}
    gen = torch.Generator().manual_seed(0)
    b, steps = 256, 100
    state, _ = vec_reset(env["cpu"], gen, b)
    flips, stiff, worst, stiff_worst = 0, 0, 0.0, 0.0
    fields = ("next_obs", "carry_obs", "reward")
    for _ in range(steps):
        action = torch.rand(b, 4, generator=gen) * 2.0 - 1.0
        reset_draw = env["cpu"].draw_reset(b, gen)
        cpu = step_auto_reset(env["cpu"], state, action, None, reset_draw)
        card = step_auto_reset(env["cuda"], to_device(state, "cuda"),
                               action.cuda(), None, reset_draw.cuda())
        same = cpu.episode_done == card.episode_done.cpu()
        flips += int((~same).sum())
        a, c = (torch.cat(
            [getattr(out, f).reshape(b, -1).cpu() for f in fields]
            + [getattr(out.state, f.name).reshape(b, -1).float().cpu()
               for f in dataclasses.fields(out.state)], 1)[same]
            for out in (cpu, card))
        err = (a - c).abs()
        off = ~(err <= 2e-5 + 1e-5 * c.abs()).all(1)
        stiff += int(off.sum())
        worst = max(worst, float(err[~off].max()) if bool((~off).any())
                    else 0.0)
        stiff_worst = max(stiff_worst, float(err.max()))
        state = cpu.state
    errs["bipedal_steps"] = worst
    if (stiff > 0.005 * b * steps or stiff_worst > 5e-3
            or flips > 0.001 * b * steps):
        raise AssertionError(
            f"BipedalWalker card vs CPU: {stiff} stiff row-steps (worst "
            f"{stiff_worst}), {flips} done flags differ")
    log(f"[card-vs-cpu onpolicy] gae (64 x 1024), one full-width update of "
        f"each PPO branch, one REINFORCE update, BipedalWalker {steps} "
        f"teacher-forced steps x {b}: ok; max errs {json.dumps(errs)}; "
        f"BipedalWalker row-steps past the tests' tolerance {stiff} of "
        f"{b * steps} (worst {stiff_worst:.3e}), done flags that differ "
        f"{flips}")


def device_kernels(prof) -> list:
    """The profiler's device events, without the spans of user annotations
    such as "Optimizer.step#Adam.step", which cover kernels counted on
    their own."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("Optimizer.")]


def adam_steps(opt: torch.optim.Optimizer) -> int:
    """The Adam steps an optimizer has taken (its first param's count; a
    host tensor, so reading it costs no device sync)."""
    for st in opt.state.values():
        return int(st["step"])
    return 0


def onpolicy_probe(algo_cls):
    """``algo_cls`` keeping what the on-policy checks read: each update's
    metrics, CUDA events, Adam steps and episode-end flags, and each
    vector step's RAW reward, flags and stored reward as
    ``process_reward`` sees them (no device sync)."""
    class Probe(algo_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.metrics, self.events, self.steps, self.windows = [], [], [], []
            self.raw, self.stored, self.step_events = [], [], []

        def process_reward(self, state, reward, episode_done):
            state, stored = super().process_reward(state, reward,
                                                   episode_done)
            self.raw.append((reward.clone(), episode_done.clone()))
            self.stored.append(stored.clone())
            self.step_events.append(torch.cuda.Event(enable_timing=True))
            self.step_events[-1].record()
            return state, stored

        def update(self, state, rollout, draws, episodes=None, **kw):
            before = state_adam_steps(state)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = super().update(state, rollout, draws, episodes,
                                            **kw)
            end.record()
            self.events.append((start, end))
            self.metrics.append(metrics)
            self.steps.append(state_adam_steps(state) - before)
            self.windows.append(rollout.adv_done.clone())
            return state, metrics

    return Probe


def record_steps(raw: list) -> list:
    """Per vector step, the returns of the episodes that ended in it (env
    order), from the RAW rewards: each env's float32 running sum (each
    agent's, for (N, A) rewards)."""
    run, out = None, []
    for reward, done in raw:
        reward, done = reward.cpu(), done.cpu()
        run = reward.clone() if run is None else run + reward
        out.append(run[done].numpy())
        run = torch.where(done.reshape(done.shape + (1,) * (run.dim() - 1)),
                          0.0, run)
    return out


def expected_record(raw: list) -> np.ndarray:
    """The episode record the loop should write from the RAW rewards,
    recorded where each episode ends, in the order episodes end (env order
    within a step)."""
    return np.concatenate(record_steps(raw))


def drive_onpolicy(env_name: str, algo_name: str, algo_cfg, loop_cfg,
                   lo: float, hi: float) -> dict:
    """train_onpolicy on the card through the user's entry points, checked
    by ``check_onpolicy``."""
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.train import train_onpolicy

    env = make(env_name, device="cuda")
    algo = onpolicy_probe(algo_classes(algo_name)[0])(
        env.dim_info, algo_cfg, device="cuda")
    label = f"{env_name} {algo_name}"
    r = run_probed(lambda: train_onpolicy(env, algo, loop_cfg), env, algo,
                   label)
    return check_onpolicy(r, loop_cfg, lo, hi, label)


def check_onpolicy(r: dict, loop_cfg, lo: float, hi: float,
                   label: str) -> dict:
    """Checks a probed train_onpolicy run: the episode record against the
    RAW rewards, returns in [lo, hi], one update per iteration and no
    sum-tree launch (finite losses: ``run_probed``). Adds the mean ms per
    vector step and prints the run's numbers."""
    algo, info, returns = r["algo"], r["info"], r["returns"]
    want = expected_record(algo.raw)[:len(returns)]
    if (len(returns) != min(info["episodes"], loop_cfg.max_episodes)
            or not np.array_equal(returns, want)):
        raise AssertionError(f"{label}: the record is not the RAW rewards' "
                             f"({len(returns)} episodes, {info})")
    if len(returns) and not (returns.min() >= lo and returns.max() <= hi):
        raise AssertionError(f"{label}: returns {returns.min()} .. "
                             f"{returns.max()} outside [{lo}, {hi}]")
    if len(algo.metrics) != info["iterations"] or r["launches"]:
        raise AssertionError(f"{label}: {len(algo.metrics)} updates for "
                             f"{info}, {r['launches']} sum-tree launches")
    # device time from the end of one update to the start of the next is
    # that iteration's rollout
    t = loop_cfg.horizon // loop_cfg.num_envs
    gaps = [algo.events[i - 1][1].elapsed_time(algo.events[i][0])
            for i in range(1, len(algo.events))]
    r["vector_step_ms"] = float(np.mean(gaps)) / t if gaps else float("nan")
    log(f"[onpolicy {label}] {info['env_steps']} env steps, "
        f"{info['iterations']} updates, {info['episodes']} episodes "
        f"(returns {returns.min() if len(returns) else 'none'} .. "
        f"{returns.max() if len(returns) else 'none'}) in "
        f"{info['elapsed_s']:.2f} s: {info['env_steps_per_s']:.0f} "
        f"env-steps/s, update {r['learn_ms']:.3f} ms, vector step "
        f"{r['vector_step_ms']:.3f} ms, peak memory {r['peak_mib']:.1f} MiB, "
        f"{sum(algo.steps)} Adam steps, finite {r['checked']}, record == "
        f"RAW rewards' ({len(returns)} episodes), sumtree launches "
        f"{r['launches']}")
    return r


def phase_onpolicy() -> int:
    """PPO on BipedalWalker-v3 at full width (PPOConfig's defaults, the
    golden row PPO_10_seed's settings), PPO on CartPole-v1 (with
    reward_scaling, so the stored rewards are not the recorded ones) and
    REINFORCE on CartPole-v1, each through train_onpolicy at 1024 envs
    for 2 iterations (T 16 for PPO, T 64 for REINFORCE). Returns the
    sum-tree launches (0 expected)."""
    from freerl_tpu_torch.algos import PPOConfig, REINFORCEConfig
    from freerl_tpu_torch.train import OnPolicyConfig

    def loop(t, iterations=2):
        return OnPolicyConfig(seed=0, num_envs=1024, horizon=1024 * t,
                              max_episodes=10**9,
                              max_env_steps=1024 * t * iterations)

    launches = 0
    # a walker episode's return: -100 at a crash, the torque cost (at most
    # 0.112 a step) and the shaping's change, within +-(130 * 200 * 14 /
    # 30 / 30 + 5 pi) over the terrain. An untrained walker's first
    # crashes come after about 47 steps, so these 32 steps may finish no
    # episode; the card-against-CPU phase steps walkers through crashes
    # and resets, and the CartPole paths below check the record
    r = drive_onpolicy("BipedalWalker-v3", "PPO",
                       PPOConfig(horizon=16384, num_envs=1024), loop(16),
                       -400.0, 400.0)
    launches += r["launches"]
    onpolicy = {"ppo_bipedal": r}
    r = drive_onpolicy("CartPole-v1", "PPO",
                       PPOConfig(horizon=16384, num_envs=1024,
                                 reward_scaling=True), loop(16), 1.0, 500.0)
    raw = torch.stack([x for x, _ in r["algo"].raw])
    if torch.equal(raw, torch.stack(r["algo"].stored)):
        raise AssertionError("PPO CartPole reward_scaling stored RAW rewards")
    launches += r["launches"]
    onpolicy["ppo_cartpole"] = r
    r = drive_onpolicy("CartPole-v1", "REINFORCE", REINFORCEConfig(),
                       loop(64), 1.0, 500.0)
    cap = REINFORCEConfig().max_eps_per_update
    for steps, ends in zip(r["algo"].steps, r["algo"].windows):
        n_done = ends.sum(0).tolist()
        filled = sum(1 for k in range(cap) if n_done[k % 1024] > k // 1024)
        if steps != filled:
            raise AssertionError(f"REINFORCE took {steps} Adam steps for "
                                 f"{filled} filled episode slots")
    launches += r["launches"]
    return launches


# ---------------------------------------------------------------------------
# The multi-agent off-policy slice
# ---------------------------------------------------------------------------
MARL_NET_FIELDS = ("actors", "actor_targets", "critics", "critic_targets",
                   "critic", "critic_target")


def marl_nets(state) -> list:
    """Every net of a multi-agent learner state, in a fixed order."""
    nets = []
    for field in MARL_NET_FIELDS:
        v = getattr(state, field, None)
        nets += v if isinstance(v, list) else [] if v is None else [v]
    return nets


def marl_env(name: str, dev: str):
    """An MPE scenario through ``make``, MAAC's discrete spread, or the
    masked spread."""
    from freerl_tpu_torch.envs import MaskedSpread, make

    if name == "MaskedSpread":
        return MaskedSpread(device=dev)
    if name == "simple_spread_v3 discrete":
        return make("simple_spread_v3", device=dev, continuous_actions=False)
    return make(name, device=dev)


def marl_rows(env, n: int, rng) -> dict:
    """Random replay rows in ``env``'s layout."""
    a, di = env.n_agents, env.dim_info
    action = (rng.uniform(-1, 1, (n, a, di.action_dim)).astype(np.float32)
              if di.is_continue else
              rng.randint(0, di.action_dim, (n, a)).astype(np.int32))
    return dict(obs=rng.randn(n, a, di.obs_dim).astype(np.float32),
                action=action,
                reward=(rng.randn(n, a) * 3).astype(np.float32),
                next_obs=rng.randn(n, a, di.obs_dim).astype(np.float32),
                done=rng.rand(n) < 0.1, episode_done=rng.rand(n) < 0.1)


# label: (env, algo, config fields, learner steps); MATD3 is MADDPG with
# twin=True, what the MATD3 factory builds
MARL_VARIANTS = {
    "MADDPG": ("simple_spread_v3", "MADDPG", dict(), 1),
    "MATD3": ("simple_spread_v3", "MADDPG", dict(twin=True), 2),
    "ATT-MADDPG": ("simple_spread_v3", "MADDPG", dict(att_critic=True), 1),
    "MADDPG learn_way 1": ("simple_spread_v3", "MADDPG",
                           dict(actor_learn_way="1"), 1),
    "MADDPG world comm": ("simple_world_comm_v3", "MADDPG", dict(), 1),
    "MASAC": ("simple_spread_v3", "MASAC", dict(), 1),
    "MAAC": ("simple_spread_v3 discrete", "MAAC", dict(), 1),
}
MARL_SCENARIOS = ("simple_spread_v3", "simple_adversary_v3", "simple_tag_v3",
                  "simple_world_comm_v3", "MaskedSpread")


def phase_card_vs_cpu_marl():
    """The multi-agent slice on the card against the CPU: 60 teacher-forced
    auto-resetting steps of each MPE scenario and of the masked spread at
    1024 envs (two 25-step truncations); one learner step of each variant
    at full width (2x128, batch 256; MATD3 two, one of them delayed) from
    identical params, replay and draws. The tests' tolerances: steps within
    1e-5, flags equal; learner states within 1e-5 bar one element in
    10,000 (an Adam step on a gradient that is float noise), none past the
    lr; losses within 1e-6 relative."""
    from freerl_tpu_torch.core.types import Transition
    from freerl_tpu_torch.envs import step_auto_reset, vec_reset
    from freerl_tpu_torch.train.marl import example_transition

    devs = ("cpu", "cuda")
    rng = np.random.RandomState(5)
    b, steps = 1024, 60
    step_errs = {}
    for name in MARL_SCENARIOS:
        env = {dev: marl_env(name, dev) for dev in devs}
        gen = torch.Generator().manual_seed(0)
        state, _ = vec_reset(env["cpu"], gen, b)
        a, di = env["cpu"].n_agents, env["cpu"].dim_info
        worst, past = 0.0, 0
        for step in range(steps):
            if di.is_continue:      # past both ends of the box
                action = torch.rand(b, a, di.action_dim, generator=gen) \
                    * 1.4 - 0.2
            else:
                action = torch.randint(0, di.action_dim, (b, a),
                                       generator=gen)
            reset_draw = env["cpu"].draw_reset(b, gen)
            cpu = step_auto_reset(env["cpu"], state, action, None, reset_draw)
            card = step_auto_reset(env["cuda"], to_device(state, "cuda"),
                                   action.cuda(), None, reset_draw.cuda())
            for flag in ("terminated", "truncated"):
                if not torch.equal(getattr(cpu, flag),
                                   getattr(card, flag).cpu()):
                    raise AssertionError(f"{name} step {step}: {flag} "
                                         f"card vs CPU")
            x, y = (torch.cat(
                [getattr(out, f).reshape(b, -1).cpu()
                 for f in ("next_obs", "carry_obs", "reward")]
                + [getattr(out.state, f.name).reshape(b, -1).float().cpu()
                   for f in dataclasses.fields(out.state)], 1)
                for out in (cpu, card))
            err = (x - y).abs().max(1).values
            worst = max(worst, float(err.max()))
            past += int((err > 1e-5).sum())
            state = cpu.state
        step_errs[name] = (worst, past)
        if past:
            raise AssertionError(f"{name}: {past} of {b * steps} row-steps "
                                 f"past 1e-5 card vs CPU (worst {worst})")

    learn_errs = {}
    for label, (env_name, algo_name, extra, n_steps) in MARL_VARIANTS.items():
        cls, cfg_cls = algo_classes(algo_name)
        cfg = cfg_cls(batch_size=256, buffer_size=8192, **extra)
        env = {dev: marl_env(env_name, dev) for dev in devs}
        algo = {dev: cls(env[dev], cfg, device=dev) for dev in devs}
        init = algo["cpu"].init(torch.Generator().manual_seed(0))
        rows = marl_rows(env["cpu"], 8192, rng)
        bufs = {dev: algo[dev].make_buffer(
            example_transition(env[dev]), num_envs=8192).add(Transition(
                **{k: torch.as_tensor(v).to(dev) for k, v in rows.items()}))
            for dev in devs}
        gen = torch.Generator().manual_seed(1)
        draws = [algo["cpu"].draw_update(bufs["cpu"], gen)
                 for _ in range(n_steps)]
        out = {}
        for dev in devs:
            st = algo[dev].init(torch.Generator(device=dev).manual_seed(0))
            for net, ref in zip(marl_nets(st), marl_nets(init)):
                net.load_state_dict(ref.state_dict())
            with torch.no_grad():
                for la, ref in zip(getattr(st, "log_alphas", []),
                                   getattr(init, "log_alphas", [])):
                    la.copy_(ref)
            losses = []
            for d in draws:
                st, m = algo[dev].update(st, bufs[dev], to_device(d, dev))
                losses += [m[k].reshape(1) for k in sorted(m)]
            vals = [p.detach().flatten() for net in marl_nets(st)
                    for p in net.parameters()]
            vals += [la.detach().reshape(1)
                     for la in getattr(st, "log_alphas", [])]
            out[dev] = (torch.cat(vals).cpu().double(),
                        torch.cat(losses).cpu().double())
        err = (out["cpu"][0] - out["cuda"][0]).abs()
        loss_err = float(((out["cpu"][1] - out["cuda"][1]).abs()
                          / out["cpu"][1].abs().clamp(min=1.0)).max())
        past = int((err > 1e-5).sum())
        lr = max(cfg.actor_lr, cfg.critic_lr)
        learn_errs[label] = (float(err.max()), past, loss_err)
        if (past > err.numel() // 10_000 or float(err.max()) > lr
                or loss_err > 1e-6):
            raise AssertionError(f"{label} learner step card vs CPU: max abs "
                                 f"err {float(err.max())}, {past} of "
                                 f"{err.numel()} past 1e-5, losses' max rel "
                                 f"err {loss_err}")
    log(f"[card-vs-cpu marl] {steps} teacher-forced steps x {b} envs: (max "
        f"abs err, row-steps past 1e-5) {json.dumps(step_errs)}; learner "
        f"steps at full width, batch 256: (max abs err, elements past 1e-5, "
        f"losses' max rel err) {json.dumps(learn_errs)}")


def log_steps(env) -> list:
    """Keep each step's reward, episode-end flags and the action's range,
    as tensors on the device (no sync), in the returned list."""
    log, step = [], env.step

    def logged(state, action, draw):
        out = step(state, action, draw)
        log.append((out[2].clone(), out[3] | out[4],
                    action.amin().reshape(1), action.amax().reshape(1)))
        return out

    env.step = logged
    return log


def marl_kernels(env, algo, num_envs: int, steps: int = 4) -> float:
    """Kernels per vector step of the multi-agent loop with the learner
    bursting every step: ``torch.profiler`` over ``steps`` vector steps
    of a fresh carry, after two of warm-up."""
    from torch.profiler import ProfilerActivity, profile

    from freerl_tpu_torch.train import marl

    cfg = marl.MARLConfig(num_envs=num_envs, start_steps=0)
    generator = torch.Generator(device="cuda").manual_seed(1)
    c = marl.start(env, algo, num_envs, generator, 10 * num_envs)
    for _ in range(2):
        marl.vector_step(env, algo, cfg, c, generator, 10 * num_envs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            marl.vector_step(env, algo, cfg, c, generator, 10 * num_envs)
        torch.cuda.synchronize()
    return len(device_kernels(prof)) / steps


# Each agent's return range over one 25-step episode, from the scenario's
# rewards. spread (N 3): every reward is <= 0; an agent's force is at most
# 5 sqrt(2) from its action plus 100 * 0.3007 from each overlapping other
# agent, 67.2 in all, so its speed stays under 0.4 * 67.2 (damping 0.25,
# dt 0.1) and its distance to a landmark under sqrt(2) + 25 * 2.69 +
# 0.9 sqrt(2) = 70: a reward is at least 0.5 * (-3 * 70) + 0.5 * (-2).
# world comm (4 adversaries, 2 good; speeds capped at 1.0 and 1.3, so any
# two entities lie within 2 sqrt(2) * (1 + 25 * 0.13) = 12.1): an
# adversary's reward lies in [-0.1 * 12.1, 5 * 8], a good agent's in
# [-5 * 4 - 2 * 20, 2 * 2 + 0.05 * 12.1].
SPREAD_RETURNS = (25 * (0.5 * -3 * 70 + 0.5 * -2), 0.0)
WORLD_COMM_RETURNS = ([(25 * -1.21, 25 * 40.0)] * 4
                      + [(25 * -60.0, 25 * 4.605)] * 2)

# label: (env, algo, config fields, vector steps, per-agent return ranges)
MARL_PATHS = {
    "MADDPG spread": ("simple_spread_v3", "MADDPG", dict(), 256,
                      [SPREAD_RETURNS] * 3),
    "MATD3 spread": ("simple_spread_v3", "MADDPG", dict(twin=True), 64,
                     [SPREAD_RETURNS] * 3),
    "ATT-MADDPG spread": ("simple_spread_v3", "MADDPG",
                          dict(att_critic=True), 64, [SPREAD_RETURNS] * 3),
    "MASAC spread": ("simple_spread_v3", "MASAC", dict(), 64,
                     [SPREAD_RETURNS] * 3),
    "MAAC discrete spread": ("simple_spread_v3 discrete", "MAAC", dict(), 64,
                             [SPREAD_RETURNS] * 3),
    "MADDPG world comm": ("simple_world_comm_v3", "MADDPG", dict(), 64,
                          WORLD_COMM_RETURNS),
}


def phase_marl(label: str) -> dict:
    """``train_marl`` at full width (the configs' defaults: 2x128, batch
    256, replay 1e6, gamma 0.95, tau 0.01), 1024 envs: the record must
    equal each agent's sums of the raw rewards, lie in the scenario's
    ranges, the learner must take one step per vector step (start_steps
    500 < 1024), continuous actions must reach the env in [0, 1], and the
    sum-tree kernel must not be launched. Then the kernels per vector
    step, profiled on a fresh carry."""
    from freerl_tpu_torch.train import MARLConfig, train_marl

    env_name, algo_name, extra, steps, ranges = MARL_PATHS[label]
    num_envs, chunk = 1024, 32
    env = marl_env(env_name, "cuda")
    log_ = log_steps(env)
    cls, cfg_cls = algo_classes(algo_name)
    algo = probe(cls)(env, cfg_cls(num_envs=num_envs, **extra),
                      device="cuda")
    cfg = MARLConfig(seed=0, num_envs=num_envs, start_steps=500,
                     chunk_size=chunk, max_env_steps=num_envs * steps,
                     max_episodes=10**9)
    r = run_probed(lambda: train_marl(env, algo, cfg), env, algo, label)
    info, returns = r["info"], r["returns"]
    algo.buffer = None
    want = expected_record([(x, d) for x, d, _, _ in log_])
    want_updates = sum(1 for t in range(1, steps + 1)
                       if t * num_envs > cfg.start_steps)
    if (not np.array_equal(returns, want)
            or returns.shape != (num_envs * (steps // 25), env.n_agents)):
        raise AssertionError(f"{label}: the record {returns.shape} is not "
                             f"each agent's sum of the raw rewards")
    lo, hi = np.array(ranges).T
    if not ((returns.min(0) >= lo).all() and (returns.max(0) <= hi).all()):
        raise AssertionError(f"{label}: returns {returns.min(0)} .. "
                             f"{returns.max(0)} outside {ranges}")
    if (info["updates"] != want_updates or len(algo.metrics) != want_updates
            or r["launches"]):
        raise AssertionError(f"{label}: {info['updates']} learner steps for "
                             f"{want_updates}, {r['launches']} sum-tree "
                             f"launches")
    if env.dim_info.is_continue:
        lo_a = float(torch.cat([x for _, _, x, _ in log_]).min())
        hi_a = float(torch.cat([x for _, _, _, x in log_]).max())
        if not (lo_a >= 0.0 and hi_a <= 1.0):
            raise AssertionError(f"{label}: env actions in [{lo_a}, {hi_a}]")
    log_.clear()
    r["kernels"] = marl_kernels(env, cls(env, cfg_cls(**extra),
                                         device="cuda"), num_envs)
    log(f"[marl {label}] {info['env_steps']} env steps, {info['updates']} "
        f"learner steps, {info['episodes']} episodes (per-agent mean return "
        f"{np.round(returns.mean(0), 2).tolist()}) in "
        f"{info['elapsed_s']:.2f} s: {info['env_steps_per_s']:.0f} "
        f"env-steps/s, learner step {r['learn_ms']:.3f} ms, "
        f"{r['kernels']:.1f} kernels per vector step, peak memory "
        f"{r['peak_mib']:.1f} MiB, finite {r['checked']}, record == raw "
        f"rewards' ({len(returns)} x {env.n_agents}), sumtree launches "
        f"{r['launches']}")
    return r


# ---------------------------------------------------------------------------
# The multi-agent on-policy slice
# ---------------------------------------------------------------------------
def state_nets(state) -> list:
    """Every net of a multi-agent on-policy state, in a fixed order: the
    actors and critics (per agent, stacked, or the attention critics), or
    MAT's encoder and decoder."""
    if hasattr(state, "encoder"):
        return [state.encoder, state.decoder]
    nets = []
    for v in (state.actors, state.critics):
        nets += v if isinstance(v, list) else [v]
    return nets


def state_adam_steps(state) -> int:
    """The Adam steps every optimizer of a learner state has taken."""
    opts = [getattr(state, "opt", None)]
    for field in ("opts", "actor_opts", "critic_opts"):
        opts += getattr(state, field, [])
    return sum(adam_steps(o) for o in opts if o is not None)


def marl_onpolicy_algo(algo_name: str, env, dev: str, probe: bool = False,
                       **kw):
    """An algo of the multi-agent on-policy family with its config's
    defaults but ``kw``; IPPO and RIPPO are MAPPO and rMAPPO with the
    configs their factories make. ``probe``: as ``onpolicy_probe``."""
    from freerl_tpu_torch import algos

    if algo_name in ("IPPO", "RIPPO"):
        cfg_cls = getattr(algos, {"IPPO": "MAPPOConfig",
                                  "RIPPO": "RMAPPOConfig"}[algo_name])
        made = getattr(algos, algo_name)(env, cfg_cls(**kw), device=dev)
        cls, cfg = type(made), made.cfg
    else:
        cls = getattr(algos, algo_name)
        cfg = getattr(algos, algo_name + "Config")(**kw)
    return (onpolicy_probe(cls) if probe else cls)(env, cfg, device=dev)


def marl_onpolicy_rollout(env, t: int, n: int, rng, per_dim_logp=False,
                          mask_dim=0) -> dict:
    """A random (T, N) rollout in ``env``'s layout; under ``mask_dim`` each
    obs ends in a 0/1 mask that allows the stored action."""
    a, di = env.n_agents, env.dim_info
    obs = rng.randn(t, n, a, di.obs_dim).astype(np.float32)
    if di.is_continue:
        action = rng.uniform(-1, 1, (t, n, a, di.action_dim)).astype(
            np.float32)
    else:
        action = rng.randint(0, di.action_dim, (t, n, a))
    if mask_dim:
        mask = (rng.rand(t, n, a, mask_dim) < 0.6).astype(np.float32)
        np.put_along_axis(mask, action[..., None], 1.0, axis=-1)
        obs[..., -mask_dim:] = mask
    ends = rng.rand(t, n) < 0.05
    lp = (t, n, a) + ((di.action_dim,) if per_dim_logp else ())
    return dict(obs=obs, action=action,
                log_pi=(rng.randn(*lp) * 0.1 - 1.6).astype(np.float32),
                reward=rng.randn(t, n, a).astype(np.float32),
                next_obs=rng.randn(t, n, a, di.obs_dim).astype(np.float32),
                done=ends & (rng.rand(t, n) < 0.5), adv_done=ends)


# label: (env, algo, config fields); at the configs' full widths
MARL_ONPOLICY_VARIANTS = {
    "MAPPO stacked": ("simple_spread_v3", "MAPPO", dict()),
    "MAPPO 12 tricks": ("simple_spread_v3", "MAPPO", dict(
        adv_norm=True, obs_norm=True, reward_scaling=True,
        orthogonal_init=True, adam_eps=True, lr_decay=True, value_clip=True,
        huber_loss=True, layer_norm=True, feature_norm=True, num_envs=64)),
    "IPPO adversary": ("simple_adversary_v3", "IPPO", dict()),
    "MAPPO attention": ("simple_spread_v3", "MAPPO", dict(attention=True)),
    "MAPPO masked": ("MaskedSpread", "MAPPO", dict(masked=True, mask_dim=5)),
    "MAPPO world comm": ("simple_world_comm_v3", "MAPPO", dict()),
    "HAPPO": ("simple_spread_v3", "HAPPO", dict()),
    "MAT discrete": ("simple_spread_v3 discrete", "MAT", dict()),
    "MAT continuous": ("simple_spread_v3", "MAT", dict()),
    "RMAPPO": ("simple_spread_v3", "RMAPPO", dict(lr_decay=True)),
    "RIPPO": ("simple_adversary_v3", "RIPPO", dict()),
}


def marl_onpolicy_rollouts(t: int, n: int) -> dict:
    """Each variant's random (t, n) rollout, drawn in the table's order from
    one seed (``scripts/update_sensitivity.py`` replays the phase's)."""
    rng = np.random.RandomState(7)
    out = {}
    for label, (env_name, algo_name, kw) in MARL_ONPOLICY_VARIANTS.items():
        env = marl_env(env_name, "cpu")
        out[label] = marl_onpolicy_rollout(
            env, t, n, rng, mask_dim=kw.get("mask_dim"),
            per_dim_logp=algo_name == "MAT" and env.dim_info.is_continue)
    return out


# label: the Adam steps the card runs free before each step is forced: half
# the first step at which any run that differs from the CPU's by rounding
# alone (the CPU in float64; the CPU and the card from params perturbed by
# 1e-7, three seeds) leaves the tolerance (``scripts/update_sensitivity.py``
# on the card, PERF.md section 6); None: no such run left it, the whole
# update runs free
FREE_STEPS = {
    "MAPPO stacked": 25, "MAPPO 12 tricks": 0, "IPPO adversary": 46,
    "MAPPO attention": 9, "MAPPO masked": 0, "MAPPO world comm": 51,
    "HAPPO": 87, "MAT discrete": None, "MAT continuous": None,
    "RMAPPO": None, "RIPPO": None,
}


class AdamSteps:
    """Every Adam step of the multi-agent on-policy updates (the
    ``step`` the algos of ``algos/mappo.py``, ``happo.py``, ``mat.py`` and
    ``rmappo.py`` share), recorded or held against a record.

    On the CPU (``record``) each step's resulting params, Adam moments and
    lr are kept. On the card each step's result is held against the CPU's.
    The first ``free`` steps (all of them if None) run free; from then on
    each step is taken from the state the CPU's step started from, and
    the card continues from the CPU's result: a full update is tens of
    Adam steps through ReLUs, clips and minima, and late in it float32
    rounding alone (the CPU in float64, or from params perturbed by 1e-7)
    moves hundreds of weights past 1e-5, so from there each step is
    compared on its own."""

    MODULES = ("mappo", "happo", "mat", "rmappo")

    def __init__(self, cpu_steps=None, free: int | None = 0):
        self.steps = [] if cpu_steps is None else cpu_steps
        self.held = cpu_steps is not None
        self.free = len(self.steps) if free is None else free
        self.k, self.worst, self.past, self.n = 0, 0.0, 0, 0
        self.past_lr = 0

    def __enter__(self):
        import importlib

        self.mods = [importlib.import_module(f"freerl_tpu_torch.algos.{m}")
                     for m in self.MODULES]
        self.real = self.mods[0].step
        for mod in self.mods:
            mod.step = self.step
        return self

    def __exit__(self, *exc):
        for mod in self.mods:
            mod.step = self.real

    @staticmethod
    def moments(opt, params):
        return [opt.state[p][k] for p in params
                for k in ("exp_avg", "exp_avg_sq")]

    def step(self, opt, params, grads):
        self.real(opt, params, grads)
        lr = opt.param_groups[0]["lr"]
        if not self.held:
            self.steps.append(
                ([p.detach().clone() for p in params],
                 [m.clone() for m in self.moments(opt, params)], lr))
            return
        want, moments, _ = self.steps[self.k]
        self.k += 1
        with torch.no_grad():
            for p, w in zip(params, want):
                d = (p - w.to(p.device)).abs()
                self.worst = max(self.worst, float(d.max()))
                self.past += int((d > 1e-5).sum())
                self.past_lr += int((d > lr).sum())
                self.n += d.numel()
            if self.k > self.free:
                for p, w in zip(params, want):
                    p.copy_(w)
                for m, w in zip(self.moments(opt, params), moments):
                    m.copy_(w)


def phase_card_vs_cpu_marl_onpolicy():
    """The multi-agent on-policy slice on the card against the CPU, at full
    width (2x128; MAT n_embd 64, one block, one head; rMAPPO hidden 128,
    GRU 64), from identical params, inputs and draws: one
    ``sample_action`` (rMAPPO and rIPPO: 16 steps, each device carrying
    its own hidden states) and one full update of a (T 16, N 64) rollout
    (15 epochs of four 256-minibatches per agent; rMAPPO's chunks of 8 on
    the CPU's extras), every Adam step of it held against the CPU's, the
    first ``FREE_STEPS`` free-running and the rest teacher-forced
    (``AdamSteps``), and every Adam step the update took seen. The
    tests' tolerances: actions and log-probs within 1e-5 (discrete actions
    equal), hidden states within 1e-5; each Adam step's params within 1e-5
    bar one element in 10,000 (an Adam step on a gradient that is float
    noise), none past the lr; metrics within 1e-5 relative."""
    from freerl_tpu_torch.algos import Rollout

    devs = ("cpu", "cuda")
    t, n = 16, 64
    rollouts = marl_onpolicy_rollouts(t, n)
    errs = {}
    for label, (env_name, algo_name, kw) in MARL_ONPOLICY_VARIANTS.items():
        env = {dev: marl_env(env_name, dev) for dev in devs}
        algo = {dev: marl_onpolicy_algo(algo_name, env[dev], dev, **kw)
                for dev in devs}
        init = algo["cpu"].init(torch.Generator().manual_seed(0))
        states = {"cpu": init}
        states["cuda"] = algo["cuda"].init(
            torch.Generator(device="cuda").manual_seed(0))
        for net, ref in zip(state_nets(states["cuda"]), state_nets(init)):
            net.load_state_dict(ref.state_dict())
        roll_np = rollouts[label]
        gen = torch.Generator().manual_seed(1)
        recurrent = hasattr(algo["cpu"], "init_policy_carry")
        worst_sample, extras = 0.0, None
        carries = {dev: algo[dev].init_policy_carry(n) for dev in devs} \
            if recurrent else {}
        dp = torch.zeros(n, dtype=torch.bool)
        ex_steps = []
        for s in range(t if recurrent else 1):
            draws = algo["cpu"].draw_action(n, gen)
            obs = torch.as_tensor(roll_np["obs"][s])
            out = {}
            for dev in devs:
                args = (states[dev], obs.to(dev), draws.to(dev))
                if recurrent:
                    args += (carries[dev], dp.to(dev))
                out[dev] = algo[dev].sample_action(*args)
            pairs = []
            if recurrent:
                for dev in devs:
                    carries[dev] = out[dev][3]
                ex_steps.append(out["cpu"][4])
                dp = torch.as_tensor(roll_np["adv_done"][s])
                pairs = [(out["cpu"][3].h_actor, out["cuda"][3].h_actor),
                         (out["cpu"][3].h_critic, out["cuda"][3].h_critic)]
            for k in range(3):
                if not out["cpu"][k].is_floating_point():
                    if not torch.equal(out["cpu"][k], out["cuda"][k].cpu()):
                        raise AssertionError(f"{label}: sampled actions "
                                             f"card vs CPU")
                else:
                    pairs.append((out["cpu"][k], out["cuda"][k]))
            worst_sample = max(worst_sample, max(
                float((a - b.cpu()).abs().max()) for a, b in pairs))
        if worst_sample > 1e-5:
            raise AssertionError(f"{label}: sample_action card vs CPU "
                                 f"{worst_sample}")
        if recurrent:
            extras = {k: torch.stack([e[k] for e in ex_steps])
                      for k in ex_steps[0]}
        roll = Rollout(**{k: torch.as_tensor(v) for k, v in roll_np.items()})
        draws = algo["cpu"].draw_update(roll, torch.Generator().manual_seed(2))
        metrics, steps = {}, None
        for dev in devs:
            kwargs = dict(episodes=torch.tensor(40, device=dev))
            if recurrent:
                kwargs["extras"] = to_device(extras, dev)
            before = state_adam_steps(states[dev])
            with AdamSteps(steps, FREE_STEPS[label]) as rec:
                _, m = algo[dev].update(states[dev], to_device(roll, dev),
                                        to_device(draws, dev), **kwargs)
            steps = rec.steps
            taken = state_adam_steps(states[dev]) - before
            if not 0 < taken == len(steps):
                raise AssertionError(
                    f"{label} on {dev}: {len(steps)} of the update's {taken} "
                    f"Adam steps seen")
            metrics[dev] = torch.stack([m[k].cpu().double()
                                        for k in sorted(m)])
        m_err = float(((metrics["cpu"] - metrics["cuda"]).abs()
                       / metrics["cpu"].abs().clamp(min=1.0)).max())
        errs[label] = (worst_sample, len(steps), rec.worst, rec.past, rec.n,
                       m_err)
        if (rec.k != len(steps) or rec.past > rec.n // 10_000 or rec.past_lr
                or m_err > 1e-5):
            raise AssertionError(
                f"{label} update card vs CPU: {rec.k} of {len(steps)} Adam "
                f"steps, max abs err {rec.worst}, {rec.past} of {rec.n} "
                f"past 1e-5, {rec.past_lr} past the lr, metrics {m_err}")
    log(f"[card-vs-cpu marl onpolicy] sample_action (rMAPPO / rIPPO {t} "
        f"steps) and one full-width update (T {t}, N {n}), Adam step by "
        f"step: (sample max abs err, Adam steps, their max abs err, elements "
        f"past 1e-5, elements, metrics max rel err) {json.dumps(errs)}")


def onpolicy_kernels(env, algo, num_envs: int = 128, t: int = 2) -> dict:
    """Kernels per vector step and per update of the on-policy loop,
    ``torch.profiler`` over ``t`` vector steps of a fresh carry (after one
    warm-up iteration) and over the update of their (t, num_envs) rollout:
    num_envs * t = 256 transitions, one minibatch an epoch at the
    configs' defaults. The kernels per Adam step are the update's over its
    Adam steps."""
    from torch.profiler import ProfilerActivity, profile

    from freerl_tpu_torch.train import onpolicy

    generator = torch.Generator(device="cuda").manual_seed(1)
    c = onpolicy.start(env, algo, num_envs, generator, 10 * num_envs)

    def rollout():
        for s in range(t):
            onpolicy.vector_step(env, algo, c, generator, 10 * num_envs, s, t)

    rollout()
    onpolicy.learn(algo, c, generator)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rollout()
        torch.cuda.synchronize()
    step_kernels = len(device_kernels(prof)) / t
    before = state_adam_steps(c.algo_state)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        onpolicy.learn(algo, c, generator)
        torch.cuda.synchronize()
    n_adam = state_adam_steps(c.algo_state) - before
    update_kernels = len(device_kernels(prof))
    return dict(vector_step=step_kernels, update=update_kernels,
                adam_steps=n_adam, adam_step=update_kernels / max(n_adam, 1))


# label: (env, algo, config fields, T, iterations, per-agent return ranges[,
# envs, 1024 if not given])
MARL_ONPOLICY_PATHS = {
    "MAPPO spread": ("simple_spread_v3", "MAPPO", dict(), 4, 7,
                     [SPREAD_RETURNS] * 3),
    "IPPO adversary": ("simple_adversary_v3", "IPPO", dict(), 4, 2, None),
    "HAPPO spread": ("simple_spread_v3", "HAPPO", dict(), 4, 2,
                     [SPREAD_RETURNS] * 3),
    "MAT spread": ("simple_spread_v3", "MAT", dict(), 4, 2,
                   [SPREAD_RETURNS] * 3),
    "MAPPO world comm": ("simple_world_comm_v3", "MAPPO", dict(), 4, 2,
                         WORLD_COMM_RETURNS),
    "RMAPPO spread": ("simple_spread_v3", "RMAPPO", dict(), 10, 1,
                      [SPREAD_RETURNS] * 3, 256),
}


def phase_marl_onpolicy(label: str) -> dict:
    """``train_onpolicy`` at 1024 envs (rMAPPO at 256: its BPTT update at
    1024 envs takes about 70 s) through the user's entry points (``make``,
    the algo class, ``OnPolicyConfig``), the configs' defaults but
    ``num_envs`` and ``horizon``: each agent's running return, and the
    (E, A) record, equal the sums of the RAW rewards (MAPPO spread runs 7
    iterations of T 4, so every env finishes a 25-step episode, and its
    record must lie in the scenario's ranges), continuous actions reach the
    env in [0, 1], one update per iteration, no sum-tree launch. Then the
    kernels per vector step and per Adam step, profiled."""
    from freerl_tpu_torch.train import OnPolicyConfig, train_onpolicy

    env_name, algo_name, extra, t, iters, ranges, *envs = \
        MARL_ONPOLICY_PATHS[label]
    num_envs = envs[0] if envs else 1024
    env = marl_env(env_name, "cuda")
    log_ = log_steps(env)
    algo = marl_onpolicy_algo(algo_name, env, "cuda", probe=True,
                              num_envs=num_envs, horizon=num_envs * t,
                              **extra)
    cfg = OnPolicyConfig(seed=0, num_envs=num_envs, horizon=num_envs * t,
                         max_episodes=10**9,
                         max_env_steps=num_envs * t * iters,
                         log_every_iters=1)
    carries = []
    r = run_probed(lambda: train_onpolicy(
        env, algo, cfg, on_iter=lambda *a: carries.append(a[3])),
        env, algo, label)
    info, returns = r["info"], r["returns"]
    raw = [(x, d) for x, d, _, _ in log_]
    run = torch.zeros_like(raw[0][0])
    for x, d in raw:                    # the running returns, raw
        run = torch.where(d[:, None], 0.0, run + x)
    if (not np.array_equal(returns, expected_record(raw))
            or not torch.equal(carries[-1].ep_return, run)):
        raise AssertionError(f"{label}: the record {returns.shape} or the "
                             f"running returns are not each agent's sums "
                             f"of the raw rewards")
    want_eps = num_envs * (t * iters // 25)
    if returns.shape != (want_eps, env.n_agents):
        raise AssertionError(f"{label}: record {returns.shape}")
    if ranges is not None and len(returns):
        lo, hi = np.array(ranges).T
        if not ((returns.min(0) >= lo).all() and (returns.max(0) <= hi).all()):
            raise AssertionError(f"{label}: returns {returns.min(0)} .. "
                                 f"{returns.max(0)} outside {ranges}")
    if (len(algo.metrics) != iters or info["iterations"] != iters
            or r["launches"]):
        raise AssertionError(f"{label}: {len(algo.metrics)} updates for "
                             f"{info}, {r['launches']} sum-tree launches")
    if env.dim_info.is_continue:
        lo_a = float(torch.cat([x for _, _, x, _ in log_]).min())
        hi_a = float(torch.cat([x for _, _, _, x in log_]).max())
        if not (lo_a >= 0.0 and hi_a <= 1.0):
            raise AssertionError(f"{label}: env actions in [{lo_a}, {hi_a}]")
    log_.clear()
    r["kernels"] = onpolicy_kernels(env, marl_onpolicy_algo(
        algo_name, env, "cuda", **extra))
    # device time between two vector steps' reward hooks; the median
    # leaves out the gaps that hold an update
    ev = algo.step_events
    r["vector_step_ms"] = float(np.median([
        ev[i - 1].elapsed_time(ev[i]) for i in range(1, len(ev))]))
    log(f"[marl onpolicy {label}] {info['env_steps']} env steps, "
        f"{info['iterations']} updates of {sum(algo.steps)} Adam steps, "
        f"{info['episodes']} episodes in {info['elapsed_s']:.2f} s: "
        f"{info['env_steps_per_s']:.0f} env-steps/s, update "
        f"{r['learn_ms']:.1f} ms, vector step {r['vector_step_ms']:.3f} ms, "
        f"kernels {json.dumps(r['kernels'])}, peak memory "
        f"{r['peak_mib']:.1f} MiB, finite {r['checked']}, record == RAW "
        f"rewards' ({returns.shape}), sumtree launches {r['launches']}")
    return r


# ---------------------------------------------------------------------------
# Slice 6: GAIL, CEM-GD3PG with the ES suite, ENVELOPE on
# deep-sea-treasure, the pixel stack
# ---------------------------------------------------------------------------
def params_of(*nets) -> torch.Tensor:
    """Every parameter of the nets, flat, on the CPU."""
    return torch.cat([p.detach().reshape(-1).cpu() for net in nets
                      for p in net.parameters()])


def held(label: str, cpu: torch.Tensor, card: torch.Tensor, errs: dict,
         lr: float | None = None, rel: bool = False) -> None:
    """Card against CPU at the tests' tolerance: 1e-5 on every element
    (relative to the CPU's magnitude, where above 1, with ``rel``), or,
    after Adam steps (``lr``), one element in 10,000 allowed past 1e-5 and
    none past the lr (an Adam step on a gradient that is float noise moves
    a weight by up to the lr on either device)."""
    err = (cpu.double() - card.double().cpu()).abs()
    if rel:
        err = err / cpu.double().abs().clamp(min=1.0)
    past = int((err > 1e-5).sum())
    errs[label] = [float(err.max()), past]
    if lr is None and past or lr is not None and (
            past > err.numel() // 10_000 or float(err.max()) > lr):
        raise AssertionError(f"{label} card vs CPU: max abs err "
                             f"{float(err.max())}, {past} of {err.numel()} "
                             f"past 1e-5")


def twins(make_algo, init_fields, devs=("cpu", "cuda")):
    """The algo and its state on each device, the card's nets loaded with
    the CPU's init (``init_fields``: the state's net fields)."""
    out = {}
    for dev in devs:
        algo = make_algo(dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        out[dev] = [algo, algo.init(gen)]
    for name in init_fields:
        getattr(out["cuda"][1], name).load_state_dict(
            getattr(out["cpu"][1], name).state_dict())
    return out


class ReluInputs(torch.overrides.TorchFunctionMode):
    """Records the input of every ReLU (``F.relu`` or ``torch.relu``) run
    while the mode is on."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.nn.functional.relu, torch.relu):
            self.seen.append(args[0].detach())
        return func(*args, **(kwargs or {}))


TIE_DRAWS = 3


def relu_ties(label: str, net_cpu, net_card, obs: torch.Tensor) -> int:
    """The ReLU inputs that the CPU's and the card's forward of ``obs`` put
    on two sides of zero, each device along its own forward. Every such
    input must lie within 1e-5 of zero on both (a tie at the float32 noise
    floor); one farther out fails."""
    seen = {}
    for dev, net in (("cpu", net_cpu), ("cuda", net_card)):
        with torch.no_grad(), ReluInputs() as mode:
            net(obs.to(dev))
        seen[dev] = [x.cpu() for x in mode.seen]
    if not seen["cpu"] or len(seen["cpu"]) != len(seen["cuda"]):
        raise AssertionError(f"{label}: ReLUs seen {len(seen['cpu'])} on "
                             f"the CPU, {len(seen['cuda'])} on the card")
    ties = 0
    for a, b in zip(seen["cpu"], seen["cuda"]):
        flip = (a > 0) != (b > 0)
        far = float(torch.maximum(a.abs(), b.abs())[flip].max()) \
            if flip.any() else 0.0
        if far > 1e-5:
            raise AssertionError(f"{label}: a ReLU input {far} from zero on "
                                 f"one device is on the other side on the "
                                 f"other")
        ties += int(flip.sum())
    return ties


PENDULUM_STEP = np.pi ** 2 + 0.1 * 8.0 ** 2 + 0.001 * 2.0 ** 2


def phase_card_vs_cpu_slice6():
    """Slice 6 on the card against the CPU, from identical params and
    draws, at the configurations' widths: GAIL's ``train_d`` (vanilla; and
    WGAN-GP with LayerNorm) and ``compute_reward``; one CEM-GD3PG
    ``learn`` of each guidance branch and a P=10 ``eval_population`` on
    Pendulum-v1 (its 200-step rollout teacher-forced); ENVELOPE's
    ``add_with_priority``, ``sample`` and ``update``, and one
    ``EnvelopeDDPG`` learner step; a DQN update
    through the 'small' and the 'nature' trunk; 200 teacher-forced
    auto-resetting steps of PixelCartPole-v1 and deep-sea-treasure-v0 at
    1024 envs."""
    from freerl_tpu_torch.algos import (CEMGD3PG, DQN, GAIL, CEMDraws,
                                        CEMGD3PGConfig, DQNConfig, Envelope,
                                        EnvelopeConfig, EnvelopeDDPG,
                                        GAILConfig, PPOConfig)
    from freerl_tpu_torch.algos.cem_gd3pg import RolloutDraws
    from freerl_tpu_torch.core.types import DimInfo, Transition
    from freerl_tpu_torch.envs import make, step_auto_reset, vec_reset

    rng = np.random.RandomState(6)
    devs = ("cpu", "cuda")
    errs = {}

    def on(dev, x):
        return torch.as_tensor(x).to(dev)

    pendulum = make("Pendulum-v1", device="cpu")

    # GAIL: one D step at full width (2x128, d_batch 256) and the relabel
    # of a 2048-row rollout
    for variant, extra in (("vanilla", {}),
                           ("wgan_gp_ln", dict(gp_coef=10.0,
                                               d_layernorm=True))):
        pair = twins(lambda dev: GAIL(pendulum.dim_info, PPOConfig(),
                                      GAILConfig(**extra), device=dev),
                     ("disc",))
        batch = [rng.randn(256, 3).astype(np.float32),
                 rng.uniform(-2, 2, (256, 1)).astype(np.float32),
                 rng.randn(256, 3).astype(np.float32),
                 rng.uniform(-2, 2, (256, 1)).astype(np.float32)]
        roll = [rng.randn(2048, 3).astype(np.float32),
                rng.uniform(-2, 2, (2048, 1)).astype(np.float32)]
        out, reward = {}, {}
        for dev, (gail, st) in pair.items():
            reward[dev] = gail.compute_reward(st.disc,
                                              *[on(dev, x) for x in roll])
            st, m = gail.train_d(st, *[on(dev, x) for x in batch])
            out[dev] = torch.cat([params_of(st.disc),
                                  m["d_loss"].reshape(1).cpu()])
        held(f"gail_{variant}_reward", reward["cpu"], reward["cuda"], errs)
        held(f"gail_{variant}_train_d", out["cpu"], out["cuda"], errs, 4e-4)

    # CEM-GD3PG at its defaults (2x128, batch 64): one learn per guidance
    # branch from the same state and batch, the domain actor a scaled
    # copy so the guidance term is live
    nets = ("actor1", "actor2", "actor1_target", "actor2_target", "domain",
            "critic", "critic_target")
    pair = twins(lambda dev: CEMGD3PG(pendulum.dim_info, device=dev), nets)
    cpu_algo, cpu_st = pair["cpu"]
    dom = cpu_algo.get_params(cpu_st.actor2) * 0.7
    for dev, (algo, st) in pair.items():
        algo.set_params(st.domain, dom)
    for i, is_f1_more in enumerate((True, False)):
        done = rng.rand(64) < 0.05
        b = Transition(obs=torch.randn(64, 3),
                       action=torch.rand(64, 1) * 4 - 2,
                       reward=torch.randn(64), next_obs=torch.randn(64, 3),
                       done=torch.as_tensor(done),
                       episode_done=torch.as_tensor(done))
        for dev, (algo, st) in pair.items():
            algo.learn(st, to_device(b, dev), is_f1_more, 0.37)
        held(f"cem_learn_{'f1' if is_f1_more else 'f2'}",
             *[params_of(*[getattr(pair[d][1], n) for n in nets])
               for d in devs], errs, 1e-3)
    # a P=10 population evaluation on Pendulum-v1 with the CPU's draws
    env = {dev: make("Pendulum-v1", device=dev) for dev in devs}
    flat = cpu_algo.get_params(cpu_st.actor1)[None] * (
        1.0 + 0.3 * rng.randn(10, 1))
    draws = CEMDraws(torch.Generator().manual_seed(0)).population(
        env["cpu"], 10, env["cpu"].max_steps)
    # The rollout behind ``eval_population``, teacher-forced over its 200
    # steps: each card step starts from the CPU's carry before it, with the
    # CPU's draws, and its transition and running return are held at the
    # tests' rtol 1e-5. A free-running comparison cannot be held there: on
    # the CPU alone, actors one float32 ulp apart (3e-8 relative) leave
    # 1e-5 within 37-110 steps and their fitness can differ by 1.03e-5
    # relative (scripts/cem_rollout_sensitivity.py, 4 seeds), and the
    # card left a 60-step free-running window on 4-10 of 1800 elements
    # (max 1.1e-5-1.6e-5) in two full calls.
    flat_t = {dev: torch.as_tensor(flat, dtype=torch.float32, device=dev)
              for dev in devs}
    carry, steps = None, {dev: [] for dev in devs}
    for t in range(len(draws.step)):
        one = RolloutDraws(reset=draws.reset, step=draws.step[t:t + 1],
                           step_reset=draws.step_reset[t:t + 1])
        card = pair["cuda"][0].rollout(env["cuda"], flat_t["cuda"],
                                       to_device(one, "cuda"),
                                       carry=to_device(carry, "cuda"))
        carry = cpu_algo.rollout(env["cpu"], flat_t["cpu"], one,
                                 carry=carry)
        for dev, c in (("cpu", carry), ("cuda", card)):
            tr = c[2].trans
            steps[dev].append(torch.cat(
                [x.reshape(10, -1).float().cpu() for x in (
                    tr.obs, tr.action, tr.reward, tr.next_obs, c[1],
                    c[2].ret)], 1))
    held("cem_rollout_teacher_forced_200_steps_rel",
         torch.stack(steps["cpu"]), torch.stack(steps["cuda"]), errs,
         rel=True)
    # eval_population is that rollout: bit-equal to the stepped one on the
    # CPU, and finite on the card
    fitness, trans = cpu_algo.eval_population(env["cpu"], flat, draws)
    card_fitness, _ = pair["cuda"][0].eval_population(
        env["cuda"], flat, to_device(draws, "cuda"))
    if (not torch.equal(fitness, carry[2].ret)
            or not torch.equal(trans.obs[-1], carry[2].trans.obs[0])
            or not bool(torch.isfinite(card_fitness).all())):
        raise AssertionError("CEM-GD3PG eval_population is not its rollout")

    # ENVELOPE at its defaults (2x256, batch 256, weight_num 4, buffer
    # 100k) on deep-sea-treasure's widths: an add of 1024 rows with its
    # priorities and homotopy bumps, a Gumbel-top-k sample from 2048
    # stored rows, one update
    dst = make("deep-sea-treasure-v0", device="cpu")
    pair = twins(lambda dev: Envelope(dst.dim_info, 2, device=dev),
                 ("net", "target_net"))
    rows = {}
    for i in range(2):
        done = rng.rand(1024) < 0.1
        rows[i] = Transition(
            obs=torch.as_tensor(rng.randint(0, 11, (1024, 2)),
                                dtype=torch.float32),
            action=torch.as_tensor(rng.randint(0, 4, 1024), dtype=torch.int32),
            reward=torch.as_tensor(rng.randn(1024, 2), dtype=torch.float32),
            next_obs=torch.as_tensor(rng.randint(0, 11, (1024, 2)),
                                     dtype=torch.float32),
            done=torch.as_tensor(done), episode_done=torch.as_tensor(done))
    prefs = [torch.randn(1024, 2) for _ in range(2)]
    gumbel, sampled = None, {}
    for dev, (algo, st) in pair.items():
        ex = to_device(rows[0].map(lambda x: x[0]), dev)
        buf = algo.make_buffer(ex, num_envs=1024)
        for i in range(2):
            st, buf = algo.add_with_priority(st, buf, to_device(rows[i], dev),
                                             prefs[i].to(dev))
        if gumbel is None:                        # the CPU's draws
            gumbel = algo.draw_sample(buf, torch.Generator().manual_seed(1))
            w = torch.randn(4, 2)
        idx = algo.sample_idx(buf, gumbel.to(dev), 256)
        st, m, _ = algo.update(st, buf.gather(idx), w.to(dev))
        sampled[dev] = (buf.priorities[:buf.size].cpu(), idx.cpu(),
                        params_of(st.net, st.target_net),
                        st.beta.cpu(), m["loss"].cpu())
    cpu, card = sampled["cpu"], sampled["cuda"]
    held("envelope_priorities_rel", cpu[0], card[0], errs, rel=True)
    if not torch.equal(cpu[1], card[1]) or not torch.equal(cpu[3], card[3]):
        raise AssertionError("ENVELOPE sample indices or beta card vs CPU")
    held("envelope_update", cpu[2], card[2], errs, 1e-3)
    # EnvelopeDDPG: one learner step on Pendulum's widths, 4096 stored rows
    pair = twins(lambda dev: EnvelopeDDPG(pendulum.dim_info, 2, device=dev),
                 ("actor", "actor_target", "critic", "critic_target"))
    batch = Transition(obs=torch.randn(256, 3),
                       action=torch.rand(256, 1) * 4 - 2,
                       reward=torch.randn(256, 2),
                       next_obs=torch.randn(256, 3),
                       done=torch.rand(256) < 0.05,
                       episode_done=torch.zeros(256, dtype=torch.bool))
    w = torch.randn(4, 2)
    out = {}
    for dev, (algo, st) in pair.items():
        st, m, _ = algo.update(st, to_device(batch, dev), w.to(dev))
        out[dev] = torch.cat([params_of(st.actor, st.actor_target, st.critic,
                                        st.critic_target),
                              st.beta.reshape(1).cpu()])
    held("envelope_ddpg_update", out["cpu"], out["cuda"], errs, 1e-3)

    # DQN through each conv trunk (pixel_curve's 'small' trunk on
    # PixelCartPole's 48x48x2 frames; the 'nature' trunk on 84x84x4): one
    # update, batch 64, from the same params and batch. Its gradients are
    # held; then the card's update runs again from the same params with
    # the CPU's gradients in place of its own (a hook on each parameter),
    # and the updated nets are held. Adam's first step is lr * g / (|g| +
    # 1e-8), +-lr wherever a gradient is float noise, so two free steps
    # put such weights up to 2 lr apart: the card's free update left 47
    # and 497 weights past 1e-5 (max 0.0019995, 0.0019999 at lr 1e-3) in
    # two full calls on the card, against 1-19 in earlier ones.
    # A batch on which the two devices' forwards send a ReLU input to two
    # sides of zero (a tie: both within float32 noise of it) has no one
    # gradient to hold: one ReLU unit's branch moves its layer's weight
    # gradients by up to ~1.6e-4 (scripts/torch_conv_check.py: 1 batch in
    # 20 for the nature trunk). Such a batch is drawn again; a ReLU input
    # the devices put on two sides of zero farther than 1e-5 from it fails.
    for arch, shape, feats in (("small", (48, 48, 2), 128),
                               ("nature", (84, 84, 4), 512)):
        obs_dim = int(np.prod(shape))
        di = DimInfo(obs_dim=obs_dim, action_dim=2)
        cfg = DQNConfig(obs_shape=shape, conv_arch=arch, cnn_features=feats,
                        batch_size=64)
        pair = twins(lambda dev: DQN(di, cfg, device=dev),
                     ("net", "target_net"))
        for _ in range(TIE_DRAWS):
            done = rng.rand(64) < 0.1
            b = Transition(obs=torch.rand(64, obs_dim),
                           action=torch.as_tensor(rng.randint(0, 2, 64)),
                           reward=torch.randn(64),
                           next_obs=torch.rand(64, obs_dim),
                           done=torch.as_tensor(done),
                           episode_done=torch.as_tensor(done))
            ties = relu_ties(f"dqn_{arch}", pair["cpu"][1].net,
                             pair["cuda"][1].net, b.obs)
            errs[f"dqn_{arch}_relu_ties"] = errs.get(
                f"dqn_{arch}_relu_ties", []) + [ties]
            if not ties:
                break
        else:
            raise AssertionError(f"dqn_{arch}: a ReLU tie in each of "
                                 f"{TIE_DRAWS} batches")
        fwd = {dev: st.net(b.obs.to(dev)).detach() for dev, (_, st) in
               pair.items()}
        held(f"dqn_{arch}_forward", fwd["cpu"], fwd["cuda"], errs)
        for dev, (algo, st) in pair.items():
            algo.update(st, to_device(b, dev))
        grads = {d: torch.cat([p.grad.flatten().cpu()
                               for p in pair[d][1].net.parameters()])
                 for d in devs}
        held(f"dqn_{arch}_grads", grads["cpu"], grads["cuda"], errs,
             rel=True)
        algo, st = twins(lambda dev: DQN(di, cfg, device=dev),
                         ("net", "target_net"))["cuda"]
        hooks = [p.register_hook(lambda _, g=g: g.to("cuda"))
                 for p, g in zip(st.net.parameters(),
                                 [p.grad for p in
                                  pair["cpu"][1].net.parameters()])]
        algo.update(st, to_device(b, "cuda"))
        for h in hooks:
            h.remove()
        held(f"dqn_{arch}_update_cpu_grads",
             params_of(pair["cpu"][1].net, pair["cpu"][1].target_net),
             params_of(st.net, st.target_net), errs)

    # 200 auto-resetting steps of 1024 envs, the card from the CPU's state
    # and draws each step. deep-sea-treasure is integer arithmetic: exact.
    # PixelCartPole's frames threshold distances computed from sin and
    # cos, which round an ulp apart on the two devices: a pixel may flip
    # where a distance lies within an ulp of its threshold (at most one
    # pixel in 10^6); the inner state is CartPole's (rtol / atol 1e-5)
    b, flips = 1024, {}
    for name in ("deep-sea-treasure-v0", "PixelCartPole-v1"):
        env = {dev: make(name, device=dev) for dev in devs}
        gen = torch.Generator().manual_seed(0)
        state, _ = vec_reset(env["cpu"], gen, b)
        pix, done_flips, worst = 0, 0, 0.0
        for t in range(200):
            action = torch.randint(0, env["cpu"].dim_info.action_dim, (b,),
                                   generator=gen)
            draws = (env["cpu"].draw_step(b, gen),
                     env["cpu"].draw_reset(b, gen))
            cpu = step_auto_reset(env["cpu"], state, action, *draws)
            card = step_auto_reset(env["cuda"], to_device(state, "cuda"),
                                   action.cuda(), *to_device(draws, "cuda"))
            same = cpu.episode_done == card.episode_done.cpu()
            done_flips += int((~same).sum())
            for field in ("next_obs", "carry_obs", "reward"):
                a = getattr(cpu, field)[same]
                c = getattr(card, field).cpu()[same]
                if name.startswith("deep"):
                    if not torch.equal(a, c):
                        raise AssertionError(f"{name} step {t} {field}")
                else:
                    pix += int((a != c).sum())
            if name.startswith("Pixel"):
                inner = [(getattr(cpu.state.inner, f.name)[same].float(),
                          getattr(card.state.inner, f.name).cpu()[same]
                          .float())
                         for f in dataclasses.fields(cpu.state.inner)]
                for a, c in inner:
                    worst = max(worst, float((a - c).abs().max()))
                    if not torch.allclose(a, c, rtol=1e-5, atol=1e-5):
                        raise AssertionError(f"{name} step {t} inner state")
            state = cpu.state
        flips[name] = [done_flips, pix, worst]
        compared = b * 200 * 2 * env["cpu"].dim_info.obs_dim
        if done_flips > 2 or pix > compared // 10**6:
            raise AssertionError(f"{name} card vs CPU: {done_flips} done "
                                 f"flags, {pix} pixels differ")
    log(f"[card-vs-cpu slice 6] GAIL train_d (vanilla, WGAN-GP + LayerNorm) "
        f"and compute_reward, CEM-GD3PG learn (both branches) and a P=10 "
        f"eval_population, ENVELOPE add / sample / update, EnvelopeDDPG, "
        f"DQN through the small and nature trunks, 200 steps x 1024 of "
        f"deep-sea-treasure and PixelCartPole: ok; (max abs err, elements "
        f"past 1e-5) {json.dumps(errs)}; env steps (done flags that differ, "
        f"pixels that differ, inner state max abs err) {json.dumps(flips)}")


def sumtree_count(run, device: str = "cuda"):
    """``run()`` with the sum-tree kernel's count set to 0 just before
    and read just after: (its result, the launches, seconds)."""
    from freerl_tpu_torch.ops import sumtree

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    sumtree.launches = 0
    t0 = time.time()
    out = run()
    launches = sumtree.launches
    sync()
    return out, launches, time.time() - t0


def pendulum_expert(obs: torch.Tensor) -> torch.Tensor:
    """GAIL's expert on Pendulum-v1: pump energy with the swing, hold near
    the top."""
    cos, sin, thdot = obs[:, 0], obs[:, 1], obs[:, 2]
    pump = torch.sign(thdot * cos + 1e-3) * 2.0
    hold = -(10.0 * torch.atan2(sin, cos) + 1.0 * thdot)
    return torch.clamp(torch.where(cos > 0.8, hold, pump), -2.0, 2.0)[:, None]


def phase_gail() -> int:
    """GAIL on Pendulum-v1 with the learner config of
    scripts/gail_e2e.py (PPO 2x128, horizon 2048, minibatch 64, lr 1e-4,
    adv_norm, orthogonal init; D 2x128, d_batch 256, d_lr 1e-4): expert
    pairs from a fixed energy-pumping controller through
    ``collect_expert_data``, three ``train_gail`` iterations at 8 envs,
    then 100 D steps on the expert set against the policy's own actions
    on the same states, which D must tell apart."""
    from freerl_tpu_torch.algos import (GAIL, GAILConfig, PPOConfig,
                                        collect_expert_data, train_gail)
    from freerl_tpu_torch.envs import make

    env = make("Pendulum-v1", device="cuda")
    gail = GAIL(env.dim_info,
                PPOConfig(horizon=2048, minibatch_size=64, num_envs=8,
                          actor_lr=1e-4, adv_norm=True, orthogonal_init=True),
                GAILConfig(d_steps_per_iter=1, d_lr=1e-4), device="cuda")

    def run():
        expert = collect_expert_data(env, pendulum_expert, 8192, seed=1)
        return expert, train_gail(env, gail, expert, num_iterations=3,
                                  num_envs=8, seed=0)

    (expert, (state, record, history)), launches, secs = sumtree_count(run)
    if len(record) != 3 or not all(np.isfinite(list(h.values())).all()
                                   for h in history):
        raise AssertionError(f"GAIL: {len(record)} iterations, {history}")
    if not (record.min() >= -PENDULUM_STEP and record.max() <= 0.0):
        raise AssertionError(f"GAIL: mean true rewards {record} outside "
                             f"[{-PENDULUM_STEP}, 0]")
    gen = torch.Generator(device="cuda").manual_seed(2)
    for _ in range(100):
        idx = expert.sample_idx(gen, 256)
        s, a = expert.gather(idx)
        policy_a = gail.ppo.evaluate_action(state.ppo_state, s)
        state, m = gail.train_d(state, s, a, s, policy_a)
    expert_p, policy_p = float(m["expert_prob"]), float(m["policy_prob"])
    if not expert_p > policy_p + 0.1:
        raise AssertionError(f"GAIL: D does not separate the expert "
                             f"({expert_p}) from the policy ({policy_p})")
    log(f"[gail Pendulum-v1] 8192 expert pairs, 3 iterations of 2048 env "
        f"steps (8 envs) in {secs:.2f} s: mean true reward per iteration "
        f"{[round(float(r), 3) for r in record]}, D expert / policy prob "
        f"{[round(h['expert_prob'], 3) for h in history]} / "
        f"{[round(h['policy_prob'], 3) for h in history]}, after 100 more D "
        f"steps {expert_p:.3f} / {policy_p:.3f}; sumtree launches {launches}")
    return launches


def phase_cem() -> int:
    """CEM-GD3PG on Pendulum-v1 with ``CEMGD3PGConfig()``'s defaults (pop
    10, 2x128, batch 64, buffer 200k) for 12 episodes: the tenth ends the
    first ES generation, so the eleventh starts with a tell / ask, a
    population evaluation and the elite mixed into the weaker actor."""
    from freerl_tpu_torch.algos import CEMGD3PG, train_cem_gd3pg
    from freerl_tpu_torch.envs import make

    env = make("Pendulum-v1", device="cuda")
    learns = []

    class Counted(CEMGD3PG):
        def learn_burst(self, state, buffer, buffer_domain, idx, *args):
            learns.append(len(idx[0]))
            return super().learn_burst(state, buffer, buffer_domain, idx,
                                       *args)

    algo = Counted(env.dim_info, device="cuda")
    (state, returns, info), launches, secs = sumtree_count(
        lambda: train_cem_gd3pg(env, algo, max_episodes=12, seed=0))
    nets = params_of(state.actor1, state.actor2, state.critic)
    if (len(returns) != 12 or not np.isfinite(returns).all()
            or not bool(torch.isfinite(nets).all())
            or state.step != sum(learns) or not learns):
        raise AssertionError(f"CEM-GD3PG: {returns}, {state.step} learner "
                             f"steps for bursts {learns}")
    if not (returns.min() >= -200 * PENDULUM_STEP and returns.max() <= 0.0):
        raise AssertionError(f"CEM-GD3PG: returns {returns}")
    log(f"[cem Pendulum-v1] 12 episodes, {info['env_steps']} env steps "
        f"(two population evaluations of 10 x 200), {state.step} learner "
        f"steps in {len(learns)} bursts, {secs:.2f} s: returns "
        f"{returns.min():.1f} .. {returns.max():.1f}, fitness EMAs "
        f"{float(state.f1_total):.1f} / {float(state.f2_total):.1f}; "
        f"sumtree launches {launches}")
    return launches


# the learner steps of ``phase_cem_graph``'s bursts: (is_f1_more, delta,
# steps), both branches, and the first branch again from its kept graph
CEM_GRAPH_BURSTS = ((True, 0.37, 70), (False, 0.81, 60), (True, 0.52, 70))


def phase_cem_graph() -> dict:
    """CEM-GD3PG's learner burst as a CUDA graph (``BurstGraph``) against
    the eager loop on the card, at scripts/r5_cem_bipedal.py's config
    (2x128, batch 256, replay 1e6) on the walker's widths: two states from
    one init, the same two replay rings (20,000 random rows each) and the
    same indices, 200 learner steps in ``CEM_GRAPH_BURSTS`` (both branches
    of ``is_f1_more``, then a graph replayed as kept), the domain actor a
    scaled copy so the guidance term is live. Every parameter of the
    seven nets and every Adam moment and step count must be bit-equal:
    the graph replays the eager step's own kernels. Returns the ms a
    learner step takes both ways (CUDA events, the last burst)."""
    from freerl_tpu_torch.algos import CEMGD3PG, CEMGD3PGConfig
    from freerl_tpu_torch.buffers import ReplayBuffer
    from freerl_tpu_torch.core.types import Transition
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.train import golden

    di = make("BipedalWalker-v3", device="cuda").dim_info
    cfg = CEMGD3PGConfig(**golden.CEM_BIPEDAL_RUNS["CEM_GD3PG_4_seed"][2])
    algos = {way: CEMGD3PG(di, cfg, device="cuda")
             for way in ("graph", "eager")}
    states = {way: a.init(torch.Generator(device="cuda").manual_seed(0))
              for way, a in algos.items()}
    dom = algos["eager"].get_params(states["eager"].actor2) * 0.7
    for way, a in algos.items():
        a.set_params(states[way].domain, dom)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = 20_000

    def ring():
        def r(*shape):
            return torch.randn((rows,) + shape, generator=gen, device="cuda")
        done = torch.rand(rows, generator=gen, device="cuda") < 0.05
        buf = ReplayBuffer.create(cfg.buffer_size, Transition(
            obs=torch.zeros(24, device="cuda"),
            action=torch.zeros(4, device="cuda"),
            reward=torch.zeros((), device="cuda"),
            next_obs=torch.zeros(24, device="cuda"),
            done=torch.zeros((), dtype=torch.bool, device="cuda"),
            episode_done=torch.zeros((), dtype=torch.bool, device="cuda")))
        return buf.add(Transition(obs=r(24), action=torch.tanh(r(4)),
                                  reward=r(), next_obs=r(24), done=done,
                                  episode_done=done))

    buffers = (ring(), ring())
    half_b = cfg.batch_size // 2
    ms = {}
    for is_f1_more, delta, n in CEM_GRAPH_BURSTS:
        idx = tuple(torch.randint(0, rows, (n, half_b), generator=gen,
                                  device="cuda") for _ in range(2))
        for way, a in algos.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            a.learn_burst(states[way], *buffers, idx, is_f1_more, delta,
                          graph=way == "graph")
            end.record()
            end.synchronize()
            ms[way] = start.elapsed_time(end) / n

    def tensors(st):
        nets = [getattr(st, f) for f in ("actor1", "actor2", "actor1_target",
                                         "actor2_target", "domain", "critic",
                                         "critic_target")]
        opts = (st.actor1_opt, st.actor2_opt, st.critic_opt)
        return [p.detach() for net in nets for p in net.parameters()] + [
            v for o in opts for pst in o.state.values()
            for k, v in sorted(pst.items()) if torch.is_tensor(v)]

    g, e = tensors(states["graph"]), tensors(states["eager"])
    differ = [i for i, (x, y) in enumerate(zip(g, e)) if not torch.equal(x, y)]
    steps = sum(n for _, _, n in CEM_GRAPH_BURSTS)
    kept = algos["graph"].__dict__.get("_burst_graph")
    if (len(g) != len(e) or differ or states["graph"].step != steps
            or states["eager"].step != steps or kept is None
            or sorted(kept.graphs) != [False, True]):
        raise AssertionError(f"cem graph: {len(differ)} of {len(g)} tensors "
                             f"differ from the eager loop's after {steps} "
                             f"learner steps (steps {states['graph'].step} / "
                             f"{states['eager'].step})")
    log(f"[cem graph] {steps} learner steps in {len(CEM_GRAPH_BURSTS)} bursts "
        f"(both branches, one graph each, replayed as kept): params and Adam "
        f"moments bit-equal to the eager loop's ({len(g)} tensors, "
        f"{sum(t.numel() for t in g)} elements); a learner step "
        f"{ms['graph']:.4f} ms from the graph, {ms['eager']:.4f} ms eager "
        f"(CUDA events, the last burst)")
    return dict(graph_ms=ms["graph"], eager_ms=ms["eager"], steps=steps)


def phase_envelope() -> int:
    """ENVELOPE through ``train_offpolicy`` on deep-sea-treasure-v0 with
    ``EnvelopeConfig()``'s defaults (2x256, batch 256, buffer 100k,
    weight_num 4), 1024 envs, 96 vector steps, a learner step each after
    the first: the record equals the raw vector rewards scalarized with
    ``record_weights``; beta advanced once per terminated row."""
    from freerl_tpu_torch.algos import Envelope
    from freerl_tpu_torch.envs import make, record_scalarize
    from freerl_tpu_torch.train import OffPolicyConfig, train_offpolicy

    env = make("deep-sea-treasure-v0", device="cuda")
    raw, dones = [], []

    class Probed(probe(Envelope)):
        def add_transition(self, state, buffer, batch, generator):
            raw.append(record_scalarize(env, batch.reward).clone())
            dones.append((batch.episode_done.clone(), batch.done.sum()))
            return super().add_transition(state, buffer, batch, generator)

    algo = Probed(env.dim_info, env.reward_dim, device="cuda")
    cfg = OffPolicyConfig(seed=0, num_envs=1024, start_steps=1000,
                          chunk_size=32, max_env_steps=1024 * 96,
                          max_episodes=10**9)
    r = run_probed(lambda: train_offpolicy(env, algo, cfg), env, algo,
                   "envelope")
    returns, info = r["returns"], r["info"]
    want = expected_record([(x, d) for x, (d, _) in zip(raw, dones)])
    bumps = int(sum(n for _, n in dones))
    if not np.array_equal(returns, want[:len(returns)]) or not len(returns):
        raise AssertionError(f"ENVELOPE: the record ({len(returns)}) is not "
                             f"the scalarized raw rewards'")
    if not (returns.min() >= -50.0 and returns.max() <= 0.5 * 22.7 + 1e-5):
        raise AssertionError(f"ENVELOPE: returns {returns.min()} .. "
                             f"{returns.max()}")
    if info["updates"] != 96 or len(algo.metrics) != 96:
        raise AssertionError(f"ENVELOPE: {info['updates']} learner steps")
    log(f"[envelope deep-sea-treasure-v0] {info['env_steps']} env steps, "
        f"{info['updates']} learner steps, {info['episodes']} episodes "
        f"(returns {returns.min():.2f} .. {returns.max():.2f}) in "
        f"{info['elapsed_s']:.2f} s: {info['env_steps_per_s']:.0f} "
        f"env-steps/s, learner step {r['learn_ms']:.3f} ms, peak memory "
        f"{r['peak_mib']:.1f} MiB, record == scalarized raw rewards', beta "
        f"{float(algo.metrics[-1]['beta']):.6f} after {bumps} bumps, finite "
        f"{r['checked']}, sumtree launches {r['launches']}")
    return r["launches"]


def phase_pixel() -> int:
    """Pixel DQN on PixelCartPole-v1 with scripts/pixel_curve.py's config
    (small trunk, 128 features, buffer 100k, batch 64) at 512 envs for 64
    vector steps, a learner step each; then one ``train_onpolicy``
    iteration of PPO with conv trunks (its defaults, 2x128 after a 'small'
    trunk of 256 features) at 256 envs, T 16."""
    from freerl_tpu_torch.algos import DQNConfig, PPOConfig
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.train import OffPolicyConfig, OnPolicyConfig

    shape = make("PixelCartPole-v1", device="cpu").obs_shape
    cfg = OffPolicyConfig(seed=0, num_envs=512, start_steps=1000,
                          chunk_size=32, max_env_steps=512 * 64,
                          max_episodes=10**9)
    r = drive("PixelCartPole-v1", DQNConfig(
        buffer_size=100_000, batch_size=64, obs_shape=shape,
        conv_arch="small", cnn_features=128), cfg)
    info, returns = r["info"], r["returns"]
    if (info["updates"] != 63 or not len(returns)
            or not (returns.min() >= 1 and returns.max() <= 500)):
        raise AssertionError(f"pixel DQN: {info}, returns {returns}")
    log(f"[pixel DQN PixelCartPole-v1] conv trunk on cuDNN's deterministic "
        f"algorithms: {info['env_steps']} env steps, "
        f"{info['updates']} learner steps, {info['episodes']} episodes "
        f"(returns {returns.min()} .. {returns.max()}) in "
        f"{info['elapsed_s']:.2f} s: {info['env_steps_per_s']:.0f} "
        f"env-steps/s, learner step {r['learn_ms']:.3f} ms, peak memory "
        f"{r['peak_mib']:.1f} MiB, sumtree launches {r['launches']}")
    launches = r["launches"]
    p = drive_onpolicy("PixelCartPole-v1", "PPO",
                       PPOConfig(horizon=256 * 16, num_envs=256,
                                 obs_shape=shape),
                       OnPolicyConfig(seed=0, num_envs=256,
                                      horizon=256 * 16, max_episodes=10**9,
                                      max_env_steps=256 * 16), 1.0, 500.0)
    return launches + p["launches"]


# ---------------------------------------------------------------------------
# slice 7: checkpoints, the CLI and eval, the host bridges, profiling

class RawLog:
    """An env proxy that keeps each vector step's RAW rewards and episode
    ends (for ``expected_record``); everything else goes to the env."""

    def __init__(self, env):
        self.env, self.raw = env, []

    def __getattr__(self, name):
        if name == "env":                   # not set yet: no recursion
            raise AttributeError(name)
        return getattr(self.env, name)

    def vec_step_auto_reset(self, *args):
        out = self.env.vec_step_auto_reset(*args)
        self.raw.append((out.reward, out.episode_done))
        return out


def cli_args(**kw):
    """The training CLI's namespace: its defaults, overridden by ``kw``."""
    from freerl_tpu_torch import cli

    args = cli.parser().parse_args([])
    vars(args).update(kw)
    return args


def random_rows(example, n: int, action_dim: int,
                generator: torch.Generator):
    """``n`` random rows in the layout of ``example`` (a Transition with
    no batch dim, on the rows' device): floats U(-1, 1), integer actions
    in [0, action_dim), flags true with p=0.1."""
    from freerl_tpu_torch.core.types import Transition

    def draw(x):
        shape, dev = (n,) + tuple(x.shape), x.device
        if x.dtype == torch.bool:
            return torch.rand(shape, generator=generator, device=dev) < 0.1
        if not x.dtype.is_floating_point:
            return torch.randint(0, action_dim, shape, generator=generator,
                                 device=dev, dtype=x.dtype)
        return torch.rand(shape, generator=generator, device=dev) * 2 - 1

    return Transition(**{f.name: draw(getattr(example, f.name))
                         for f in dataclasses.fields(example)})


def random_rollout(env, algo, t: int, n: int, generator: torch.Generator):
    """A random (T, N[, A]) rollout in the env's layout (Beta actions in
    (0, 1)); episodes end on about one step in ten."""
    from freerl_tpu_torch.algos import Rollout

    dev, di = env.device, env.dim_info
    lead = (t, n) + ((env.n_agents,) if hasattr(env, "n_agents") else ())

    def u(shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=dev)

    if not di.is_continue:
        action = torch.randint(0, di.action_dim, lead, generator=generator,
                               device=dev)
    elif getattr(algo.cfg, "beta_dist", False):
        action = u(lead + (di.action_dim,), 0.02, 0.98)
    else:
        action = u(lead + (di.action_dim,))
    ends = u((t, n), 0.0, 1.0) < 0.1
    return Rollout(obs=u(lead + (di.obs_dim,)), action=action,
                   log_pi=u(lead, -2.0, -1.0), reward=u(lead),
                   next_obs=u(lead + (di.obs_dim,)),
                   done=ends & (u((t, n), 0.0, 1.0) < 0.7), adv_done=ends)


# What ``card-vs-cpu slice 7`` checkpoints: the CLI's flags for the algo (its
# config's full widths) and the updates the state takes before the save.
# TD3 saves after an odd number: inside its delay phase.
CHECKPOINT_CASES = {
    "Rainbow DQN": (dict(algo="DQN", env_name="LunarLander-v2",
                         trick=["Double", "Dueling", "PER", "Noisy",
                                "N_Step", "Categorical"]), 3),
    "DDPG PopArt ObsNorm": (dict(algo="DDPG",
                                 env_name="LunarLanderContinuous-v2",
                                 trick=["PopArt", "ObsNorm"]), 3),
    "TD3": (dict(algo="TD3", env_name="LunarLanderContinuous-v2"), 3),
    "PPO all tricks": (dict(algo="PPO", env_name="BipedalWalker-v3",
                            trick=["adv_norm", "ObsNorm", "reward_scaling",
                                   "lr_decay", "orthogonal_init",
                                   "adam_eps", "tanh", "Beta"]), 2),
    "MAPPO stacked": (dict(algo="MAPPO", env_name="simple_spread_v3"), 2),
    "MATD3": (dict(algo="MATD3", env_name="simple_spread_v3"), 3),
}
CKPT_ENVS, CKPT_T = 16, 16      # replay adds / rollouts of 16 envs


class CheckpointCase:
    """One algo of ``CHECKPOINT_CASES`` on ``device``: its batch source (a
    replay filled with random rows, or a random rollout) and ``update(state,
    k)``, the state's k-th update from draws seeded with k. Updates also
    feed random observations (and, on-policy, rewards) through the algo's
    normalizers, so their statistics move too."""

    def __init__(self, name: str, device: str):
        from freerl_tpu_torch.cli import MARL_OFF, OFFPOLICY, build
        from freerl_tpu_torch.train import loop, marl

        flags, self.before = CHECKPOINT_CASES[name]
        self.args = cli_args(**flags, device=device, num_envs=CKPT_ENVS,
                             horizon=CKPT_ENVS * CKPT_T, buffer_size=1 << 14,
                             batch_size=256)
        self.env, self.algo = build(self.args)
        self.device = device
        g = self.generator(-1)
        di = self.env.dim_info
        self.offpolicy = flags["algo"] in OFFPOLICY | MARL_OFF
        if self.offpolicy:
            example = (marl.example_transition(self.env)
                       if flags["algo"] in MARL_OFF
                       else loop.example_transition(self.env, self.algo))
            self.source = self.algo.make_buffer(example, num_envs=CKPT_ENVS)
            for _ in range(64):
                self.source = self.source.add(random_rows(
                    example, CKPT_ENVS, di.action_dim, g))
        else:
            self.source = random_rollout(self.env, self.algo, CKPT_T,
                                         CKPT_ENVS, g)

    def generator(self, k: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(1000 + k)

    def init(self, seed: int):
        return self.algo.init(torch.Generator(
            device=self.device).manual_seed(seed))

    def update(self, state, k: int):
        g = self.generator(k)
        obs = (self.source.data.obs[:CKPT_ENVS] if self.offpolicy
               else self.source.obs[k % CKPT_T])
        noisy = obs + 0.1 * torch.randn(obs.shape, generator=g,
                                        device=obs.device)
        state, _, _ = self.algo.process_obs(state, noisy, noisy)
        if self.offpolicy:
            buffer = copy.deepcopy(self.source)
            state, _, _ = self.algo.learn_step(state, buffer, g, CKPT_ENVS)
            return state
        reward = self.source.reward[k % CKPT_T]
        state, _ = self.algo.process_reward(state, reward,
                                            self.source.adv_done[k % CKPT_T])
        roll = self.source
        state, _ = self.algo.update(
            state, roll, self.algo.draw_update(roll, g),
            episodes=torch.tensor(37 + 29 * k, device=self.device))
        return state


def tree_diffs(a, b, path: str = "state") -> list:
    """The paths where two checkpoint trees (``runio.state_tree``) differ:
    tensors bit for bit (shape and dtype too), host values by ``==``."""
    if isinstance(a, torch.Tensor):
        same = (isinstance(b, torch.Tensor) and a.shape == b.shape
                and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()))
        return [] if same else [path]
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            return [path]
        return [d for k in a for d in tree_diffs(a[k], b[k],
                                                 f"{path}[{k!r}]")]
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return [path]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in tree_diffs(x, y, f"{path}[{i}]")]
    return [] if a == b and type(a) is type(b) else [path]


def checkpoint_roundtrip(name: str, device: str, path: str) -> dict:
    """Save ``name``'s state after ``before`` updates on ``device``; load
    it on the CPU (into a fresh CPU init, every tensor and host field bit
    for bit) and on ``device`` (into a fresh init); then one more update
    of the live and of the restored state from identical inputs and draws
    must stay bit-equal. Returns the seconds and the file's bytes."""
    from freerl_tpu_torch.train.runio import (load_checkpoint,
                                              save_checkpoint, state_tree)

    case = CheckpointCase(name, device)
    live = case.init(0)
    for k in range(case.before):
        live = case.update(live, k)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t0 = time.time()
    save_checkpoint(path, live)
    save_s = time.time() - t0
    want = state_tree(live)
    cpu = CheckpointCase(name, "cpu") if device != "cpu" else case
    diffs = tree_diffs(want, state_tree(load_checkpoint(path, cpu.init(1))))
    if diffs:
        raise AssertionError(f"{name}: loaded on the CPU, {len(diffs)} "
                             f"fields differ: {diffs[:5]}")
    fresh = case.init(1)
    moved = tree_diffs(want, state_tree(fresh))
    if "state['step']" not in moved or len(moved) < 4:
        raise AssertionError(f"{name}: the live state has not moved from a "
                             f"fresh init ({moved})")
    sync()
    t0 = time.time()
    restored = load_checkpoint(path, fresh)
    sync()
    load_s = time.time() - t0
    if restored is not fresh or tree_diffs(want, state_tree(restored)):
        raise AssertionError(f"{name}: not restored in place, bit for bit")
    k = case.before
    diffs = tree_diffs(state_tree(case.update(live, k)),
                       state_tree(case.update(restored, k)))
    if diffs:
        raise AssertionError(f"{name}: the update after the load differs "
                             f"in {len(diffs)} fields: {diffs[:5]}")
    return dict(save_s=save_s, load_s=load_s, bytes=os.path.getsize(path),
                updates=case.before + 1)


def phase_card_vs_cpu_slice7():
    """Checkpoints of six algos saved on the card, loaded on the CPU and
    on the card, and continued there bit-exact (``checkpoint_roundtrip``);
    then ``HostSmacVecEnv(FakeSmacEnv, use_state=True)`` stepped on the card
    and on the CPU from one seed and one action sequence: identical
    tensors."""
    import tempfile

    from freerl_tpu_torch.envs.host import HostEnvState
    from freerl_tpu_torch.envs.smac import FakeSmacEnv, HostSmacVecEnv

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(CHECKPOINT_CASES):
            out[name] = checkpoint_roundtrip(name, "cuda",
                                             os.path.join(tmp, f"c{i}"))
    envs = {dev: HostSmacVecEnv(FakeSmacEnv, 64, use_state=True, device=dev)
            for dev in ("cpu", "cuda")}
    rng = np.random.default_rng(0)
    obs = {dev: e._tensor(e._host_reset(1234)) for dev, e in envs.items()}
    flags = 0
    for t in range(100):
        if not torch.equal(obs["cpu"], obs["cuda"].cpu()):
            raise AssertionError(f"HostSmacVecEnv: obs differ at step {t}")
        action = torch.from_numpy(rng.integers(0, 5, (64, 3)))
        outs = {dev: e.vec_step_auto_reset(HostEnvState(t), action.to(dev),
                                           None, 64)
                for dev, e in envs.items()}
        for f in ("next_obs", "carry_obs", "reward", "terminated",
                  "truncated"):
            if not torch.equal(getattr(outs["cpu"], f),
                               getattr(outs["cuda"], f).cpu()):
                raise AssertionError(f"HostSmacVecEnv: {f} differs")
        flags += int(outs["cpu"].terminated.sum())
        obs = {dev: o.carry_obs for dev, o in outs.items()}
    log(f"[card-vs-cpu slice 7] checkpoints saved on the card, loaded on "
        f"the CPU and the card, one more update bit-equal: "
        + "; ".join(f"{n} {r['bytes']} B, save {r['save_s'] * 1e3:.1f} ms, "
                    f"load {r['load_s'] * 1e3:.1f} ms"
                    for n, r in out.items())
        + f"; HostSmacVecEnv use_state 100 steps x 64 card == CPU "
          f"({flags} episode ends)")


# A LunarLander return: a crash ends at -100 plus the shaping terms (an
# untrained lander rarely leaves [-1000, 0]), a landing scores at most ~320.
LUNAR_RETURNS = (-2000.0, 400.0)


def phase_cli() -> int:
    """The user's entry points on the card: ``cli.run`` trains DQN with PER
    (the CLI's cumsum sampler) on LunarLander-v2 at full width, 1024 envs,
    replay 1e6, batch 256, to 2048 episodes with a checkpoint every 1024;
    the run dir must be ``DQN_PER_1`` with ``config.json``, the curve and
    ``checkpoint``. Then ``eval.score`` on that run dir alone, 100 held-out
    episodes on the card; and the checkpoint's size and its save and load
    times."""
    import contextlib
    import io
    import tempfile

    from freerl_tpu_torch import cli
    from freerl_tpu_torch import eval as port_eval
    from freerl_tpu_torch.train.runio import load_checkpoint, save_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--algo", "DQN", "--env_name", "LunarLander-v2", "--trick",
                "PER", "--num_envs", "1024", "--buffer_size", "1000000",
                "--batch_size", "256", "--max_episodes", "2048",
                "--no_tensorboard", "--save_freq", "1024",
                "--results_root", tmp]
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            model_dir, launches, train_s = sumtree_count(
                lambda: cli.run(argv))
        for line in printed.getvalue().splitlines():
            log(f"  cli | {line}")
        summary = next(line for line in printed.getvalue().splitlines()
                       if line.startswith("episodes: "))
        stats = dict(kv.split(": ") for kv in summary.split("  "))
        if (os.path.basename(model_dir) != "DQN_PER_1" or not {
                "config.json", "DQN_seed_0.npy", "checkpoint"} <= set(
                    os.listdir(model_dir))):
            raise AssertionError(f"cli: run dir {os.listdir(model_dir)}")
        config = json.load(open(os.path.join(model_dir, "config.json")))
        curve = np.load(os.path.join(model_dir, "DQN_seed_0.npy"))
        if (config["device"] != "cuda" or len(curve) != 2048
                or not np.isfinite(curve).all()
                or not LUNAR_RETURNS[0] <= curve.min() <= curve.max()
                <= LUNAR_RETURNS[1]):
            raise AssertionError(f"cli: config {config}, curve "
                                 f"{len(curve)} episodes, {curve.min()} .. "
                                 f"{curve.max()}")
        if launches:
            raise AssertionError(f"cli: {launches} sum-tree launches")

        args = port_eval.parse(["--model_dir", model_dir, "--n_episodes",
                                "100", "--seed0", "1"])
        torch.cuda.synchronize()
        t0 = time.time()
        returns = port_eval.score(args)
        eval_s = time.time() - t0
        if (args.device != "cuda" or returns.shape != (100,)
                or not np.isfinite(returns).all()
                or not LUNAR_RETURNS[0] <= returns.min() <= returns.max()
                <= LUNAR_RETURNS[1]):
            raise AssertionError(f"eval: {returns}")

        path = os.path.join(model_dir, "checkpoint")
        _, algo = cli.build(args)
        state = algo.init(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        t0 = time.time()
        load_checkpoint(path, state)
        torch.cuda.synchronize()
        load_ms = (time.time() - t0) * 1e3
        t0 = time.time()
        save_checkpoint(os.path.join(tmp, "again"), state)
        save_ms = (time.time() - t0) * 1e3
        size = os.path.getsize(path)
    log(f"[cli] DQN PER LunarLander-v2 1024 envs: run dir DQN_PER_1 with "
        f"config.json, curve, checkpoint; {stats['episodes']} episodes, "
        f"{stats['env_steps']} env steps, {stats['steps/s']} env-steps/s "
        f"(the loop's), cli.run {train_s:.2f} s; eval.score 100 held-out "
        f"episodes on the card in {eval_s:.2f} s: mean {returns.mean():.1f} "
        f"({returns.min():.1f} .. {returns.max():.1f}); checkpoint {size} B, "
        f"save {save_ms:.2f} ms, load {load_ms:.2f} ms; sumtree launches "
        f"{launches}")
    return launches


def phase_host() -> int:
    """``HostVecEnv`` around ``NumpyCartPole`` (gymnasium's CartPole-v1 in
    numpy with duck-typed spaces: the card's machine may lack gymnasium),
    64 envs, in process and over 2 worker processes; DQN (full width,
    batch 256) through ``train_offpolicy``, 2 chunks of 64 vector steps.
    The learner steps once per vector step after ``start_steps``, and the
    record equals the raw rewards' sums."""
    from chip_smoke import NumpyCartPole    # by module path, for the pickle
    from freerl_tpu_torch.algos import DQN, DQNConfig
    from freerl_tpu_torch.envs.host import HostVecEnv
    from freerl_tpu_torch.train import OffPolicyConfig, train_offpolicy

    n, chunk = 64, 64
    cfg = OffPolicyConfig(num_envs=n, chunk_size=chunk, start_steps=1024,
                          max_env_steps=n * chunk * 2, max_episodes=10**9)
    rates = {}
    for workers in (0, 2):
        env = RawLog(HostVecEnv(NumpyCartPole, num_envs=n,
                                num_workers=workers, device="cuda"))
        algo = DQN(env.dim_info, DQNConfig(buffer_size=100_000,
                                           batch_size=256), device="cuda")
        try:
            (_, returns, info), launches, _ = sumtree_count(
                lambda: train_offpolicy(env, algo, cfg))
        finally:
            env.close()
        steps = info["env_steps"] // n
        want_updates = sum(1 for t in range(1, steps + 1)
                           if t * n > cfg.start_steps)
        if (info["updates"] != want_updates or launches
                or not np.array_equal(returns, expected_record(env.raw))
                or not len(returns) or not np.isfinite(returns).all()):
            raise AssertionError(f"host ({workers} workers): {info}, "
                                 f"{launches} sum-tree launches, record "
                                 f"{len(returns)}")
        if workers and any(p.is_alive() for p in env._procs):
            raise AssertionError("host: a worker outlived close()")
        rates[workers] = info["env_steps_per_s"]
        log(f"[host {workers} workers] NumpyCartPole x {n}: {steps} vector "
            f"steps, {info['updates']} learner steps, {info['episodes']} "
            f"episodes (record == raw sums, returns {returns.min():.0f} .. "
            f"{returns.max():.0f}) in {info['elapsed_s']:.2f} s: "
            f"{info['env_steps_per_s']:.0f} env-steps/s")
    return 0


def phase_smac() -> int:
    """``cli.build`` for ``--algo MAPPO --env_name fake-smac --use_state``
    on the card (masked MAPPO with the state-augmented critic over
    ``HostSmacVecEnv``), then ``train_onpolicy`` for 2 iterations (4 envs,
    horizon 100): no unavailable action reaches the envs."""
    from freerl_tpu_torch import cli
    from freerl_tpu_torch.train import OnPolicyConfig, train_onpolicy

    args = cli_args(algo="MAPPO", env_name="fake-smac", use_state=True,
                    num_envs=4, horizon=100, device="cuda")
    env, algo = cli.build(args)
    cfg = OnPolicyConfig(num_envs=4, horizon=100, max_env_steps=200,
                         max_episodes=10**9)
    (state, returns, info), launches, secs = sumtree_count(
        lambda: train_onpolicy(env, algo, cfg))
    if (info["iterations"] != 2 or state.step != 2 or launches
            or env.invalid_actions_received
            or not algo.cfg.masked or algo.cfg.state_dim != env.state_dim
            or returns.shape != (info["episodes"], 3)
            or not np.isfinite(returns).all()):
        raise AssertionError(f"smac: {info}, step {state.step}, "
                             f"{env.invalid_actions_received} invalid "
                             f"actions, {launches} sum-tree launches")
    log(f"[smac] MAPPO masked + state (state_dim {env.state_dim}) on "
        f"fake-smac x 4: {info['iterations']} iterations, "
        f"{info['episodes']} episodes (team returns {returns[:, 0].min()} "
        f".. {returns[:, 0].max()}), 0 invalid actions, {secs:.2f} s")
    return launches


def phase_profiling() -> int:
    """``utils.profiling.trace`` around 8 vector steps of the main path
    (DQN with PER on the tree sampler, LunarLander-v2, 1024 envs, full
    width, a learner step on every vector step), after one untraced
    warm-up run: the Chrome trace it exports must hold CUDA kernel
    events."""
    import tempfile

    from freerl_tpu_torch.algos import DQN, DQNConfig
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.train import OffPolicyConfig, train_offpolicy
    from freerl_tpu_torch.utils import trace

    n = 1024
    env = make("LunarLander-v2", device="cuda")
    algo = DQN(env.dim_info, DQNConfig(buffer_size=1_000_000,
                                       batch_size=256, per=True,
                                       per_sampler="tree"), device="cuda")
    cfg = OffPolicyConfig(num_envs=n, chunk_size=8, start_steps=0,
                          max_env_steps=8 * n, max_episodes=10**9)
    train_offpolicy(env, algo, cfg)              # warm-up, untraced
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp, device="cuda"):
            (_, _, info), launches, secs = sumtree_count(
                lambda: train_offpolicy(env, algo, cfg))
        path = os.path.join(tmp, "trace.json")
        size = os.path.getsize(path)
        events = json.load(open(path))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    b1 = [e for e in kernels if "sumtree" in e.get("name", "")]
    busy_us = sum(e.get("dur", 0) for e in kernels)
    if not kernels or info["updates"] != 8 or launches != 8:
        raise AssertionError(f"profiling: {len(kernels)} kernel events, "
                             f"{info['updates']} learner steps, {launches} "
                             f"sum-tree launches")
    log(f"[profiling] trace() around 8 vector steps of the main path: "
        f"{size} B Chrome trace, {len(events)} events, {len(kernels)} CUDA "
        f"kernels ({len(kernels) / 8:.1f} per vector step, {busy_us:.0f} us "
        f"of kernel time in {secs * 1e3:.1f} ms traced), sum-tree kernel "
        f"events {len(b1)} for {launches} launches")
    return launches


# The learning checks, one recipe each: the env, the algo, its config's and
# the loop config's fields (the off-policy loop unless ``driver`` says
# "onpolicy" or "marl"), the episodes read at each end, and the threshold
# the mean of the last ones (over agents too, for "marl") must clear.
# scripts/learning_seeds.py runs these same recipes over seeds; each
# threshold is set from that spread.
LEARNING_CHECKS = {
    # the port on the CPU, seeds 0-19, read 40.1-431.9 as the mean of the
    # last 30 of 250 episodes, three seeds under 60; a uniform-random policy
    # averages about 22. The JAX package's recipe expects more than 60.
    "cartpole": dict(
        env="CartPole-v1", algo="DQN",
        algo_cfg=dict(buffer_size=20_000, batch_size=64),
        loop=dict(num_envs=8, max_episodes=250, start_steps=500,
                  updates_per_burst=4, chunk_size=128),
        read=(10, 30), threshold=30.0),
    # the JAX package's recipe and threshold (tests/test_continuous.py:
    # 149-159); the port on the CPU, seeds 0-19, clears it in every seed
    "sac_pendulum": dict(
        env="Pendulum-v1", algo="SAC",
        algo_cfg=dict(buffer_size=50_000, num_envs=8),
        loop=dict(num_envs=8, max_episodes=120, start_steps=1000,
                  random_steps=1000, updates_per_burst=4, chunk_size=100),
        read=(20, 20), threshold=-500.0),
    # the JAX package's recipe (tests/test_onpolicy.py:107-113), which
    # expects more than 100; the port on the CPU, seeds 0-19, read
    # 451.7-500.0 as the mean of the last 30 of 300 episodes, from 14-21
    # over the first 10
    "ppo_cartpole": dict(
        env="CartPole-v1", algo="PPO", driver="onpolicy",
        algo_cfg=dict(horizon=1024, minibatch_size=64, num_envs=8,
                      adv_norm=True),
        loop=dict(num_envs=8, max_episodes=300, horizon=1024),
        read=(10, 30), threshold=300.0),
    # MATD3 (MADDPG with twin=True, what the MATD3 factory builds) on
    # simple_spread_v3, the JAX package's recipe (tests/test_marl.py:
    # 279-289), which expects the agent-mean of the last 50 of 300 episodes
    # above -20; read as the mean over agents and episodes. The port on the
    # CPU, seeds 0-19, read -20.1 to -17.4; with every lr at 0 (--frozen),
    # -25.7 to -21.5, so the threshold sits between the two
    "matd3_spread": dict(
        env="simple_spread_v3", algo="MADDPG", driver="marl",
        algo_cfg=dict(twin=True, num_envs=8, actor_lr=1e-3, critic_lr=1e-3),
        loop=dict(num_envs=8, max_episodes=300, chunk_size=128),
        read=(10, 50), threshold=-20.8),
    # MAPPO (stacked) on simple_spread_v3, the JAX package's recipe
    # (tests/test_marl_onpolicy.py:120-129: 8 envs, horizon 512, K_epochs
    # 5, minibatch 256, adv_norm, 400 episodes through train_onpolicy),
    # which expects the last 40 episodes 0.5 above the first 40; read as
    # the mean over agents and episodes. The port on the CPU, seeds 0-19,
    # read -23.50 to -19.34 as trained and -27.31 to -22.22 with every lr at
    # 0 (--frozen): the spreads overlap, so the threshold sits just above
    # every frozen seed, where 18 of the 20 trained ones clear it
    "mappo_spread": dict(
        env="simple_spread_v3", algo="MAPPO", driver="onpolicy",
        algo_cfg=dict(num_envs=8, horizon=512, K_epochs=5,
                      minibatch_size=256, adv_norm=True),
        loop=dict(num_envs=8, max_episodes=400, horizon=512),
        read=(40, 40), threshold=-22.2),
}


def recipe_run(rec: dict, seed: int, device: str, algo_cls=None):
    """The env, the algo and a call that trains it as recipe ``rec`` says,
    with the loop's seed ``seed``; ``algo_cls`` replaces the recipe's algo
    class (a probe of it)."""
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.train import (MARLConfig, OffPolicyConfig,
                                        OnPolicyConfig, train_marl,
                                        train_offpolicy, train_onpolicy)

    cls, cfg_cls = algo_classes(rec["algo"])
    env = make(rec["env"], device=device)
    if rec.get("driver") == "marl":      # the multi-agent algos take the env
        algo = (algo_cls or cls)(env, cfg_cls(**rec["algo_cfg"]),
                                 device=device)
        cfg = MARLConfig(seed=seed, **rec["loop"])
        return env, algo, lambda: train_marl(env, algo, cfg)
    # the multi-agent on-policy algos take the env too
    algo = (algo_cls or cls)(env if getattr(env, "n_agents", 1) > 1
                             else env.dim_info, cfg_cls(**rec["algo_cfg"]),
                             device=device)
    if rec.get("driver") == "onpolicy":
        cfg = OnPolicyConfig(seed=seed, **rec["loop"])
        return env, algo, lambda: train_onpolicy(env, algo, cfg)
    cfg = OffPolicyConfig(seed=seed, **rec["loop"])
    return env, algo, lambda: train_offpolicy(env, algo, cfg)


def phase_learning(name: str) -> dict:
    """The learning check ``LEARNING_CHECKS[name]`` on the card, seed 0,
    with the checks of its driver's phases. Returns the sum-tree
    launches, the check's ``[learning ...]`` line and its readings (the
    means of the first and of the last episodes it reads)."""
    from freerl_tpu_torch.train import OnPolicyConfig

    rec = LEARNING_CHECKS[name]
    onpolicy = rec.get("driver") == "onpolicy"
    cls = algo_classes(rec["algo"])[0]
    env, algo, run = recipe_run(
        rec, 0, "cuda", onpolicy_probe(cls) if onpolicy else probe(cls))
    label = f"learning {name}"
    r = run_probed(run, env, algo, label)
    returns, info = r["returns"], r["info"]
    if onpolicy:
        check_onpolicy(r, OnPolicyConfig(**rec["loop"]), -np.inf, np.inf,
                       label)
    elif (len(algo.metrics) != info["updates"]
          or len(returns) != min(info["episodes"],
                                 rec["loop"]["max_episodes"])):
        raise AssertionError(f"{label}: {len(algo.metrics)} metrics, "
                             f"{len(returns)} returns for {info}")
    (n_first, n_last), threshold = rec["read"], rec["threshold"]
    first = float(returns[:n_first].mean())
    last = float(returns[-n_last:].mean())
    steps = info.get("updates", info.get("iterations"))
    line = (f"[learning {rec['env']} {rec['algo']}] {len(returns)} episodes, "
            f"{info['env_steps']} env steps, {steps} learner steps or "
            f"updates in {info['elapsed_s']:.1f} s (each "
            f"{r['learn_ms']:.3f} ms): first {n_first} episodes "
            f"{first:.1f}, last {n_last} {last:.1f} (threshold {threshold})")
    if len(returns) != rec["loop"]["max_episodes"] or not last > threshold:
        raise AssertionError(f"{rec['algo']} did not learn {rec['env']}: "
                             f"last {n_last} mean {last}")
    return dict(launches=r["launches"], line=line, first=first, last=last)


# seconds a learning check may take in the side-by-side block: at least
# twice the longest any check took alone on the card (SAC Pendulum,
# 140-229 s, PRs 4-15)
LEARNING_TIMEOUT_S = 600.0


def global_rng_states() -> dict:
    """The process's global random states: torch's CPU generator, every
    card's, numpy's and Python's."""
    import random

    return dict(
        torch=torch.get_rng_state(),
        cuda=(torch.cuda.get_rng_state_all() if torch.cuda.is_available()
              else []),
        numpy=np.random.get_state(legacy=False), random=random.getstate())


def moved_rngs(before: dict, after: dict) -> list:
    """The global random states of ``global_rng_states`` that moved."""
    same = dict(
        torch=torch.equal(before["torch"], after["torch"]),
        cuda=(len(before["cuda"]) == len(after["cuda"]) and all(
            torch.equal(a, b) for a, b in zip(before["cuda"],
                                              after["cuda"]))),
        numpy=(str(before["numpy"]) == str(after["numpy"])),
        random=before["random"] == after["random"])
    return [k for k, v in same.items() if not v]


def side_child(fn, name: str, args: tuple, path: str) -> None:
    """One check of ``side_by_side``, in a spawned process: ``fn(name,
    *args)`` with the parent's TF32 settings (off), its result, its seconds
    and the global random states it moved pickled to ``path``. An exception
    ends the process with a non-zero exit code and its traceback on
    stderr."""
    import pickle

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    before = global_rng_states()
    out = fn(name, *args)
    rec = dict(out=out, seconds=time.time() - t0,
               moved=moved_rngs(before, global_rng_states()))
    with open(path, "wb") as f:
        pickle.dump(rec, f)


def side_by_side(fn, names, args: tuple = (),
                 timeout: float = LEARNING_TIMEOUT_S) -> tuple:
    """``fn(name, *args)`` for every name at once, each in a spawned
    process. Returns ``({name: record}, wall seconds)``, where a record has
    ``fn``'s result (``out``), the child's own ``seconds`` and the global
    random states it moved (``moved``). A child that exits non-zero, or
    still runs ``timeout`` seconds after the start, fails the block: the
    children still running are killed and reaped, and an
    ``AssertionError`` names every check that failed. Every child is
    joined before it returns."""
    import multiprocessing as mp
    import pickle
    import tempfile

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        procs = {name: ctx.Process(
            target=side_child, name=f"check {name}",
            args=(fn, name, args, os.path.join(d, f"{name}.pkl")))
            for name in names}
        for p in procs.values():
            p.start()
        failed = []
        while not failed and any(p.is_alive() for p in procs.values()):
            time.sleep(0.2)
            late = time.time() - t0 > timeout
            failed = [f"{name}: " + (f"still running after {timeout:.0f} s"
                                     if p.is_alive() else
                                     f"exit code {p.exitcode}")
                      for name, p in procs.items()
                      if p.exitcode not in (None, 0)
                      or late and p.is_alive()]
        for p in procs.values():
            if p.is_alive():
                p.kill()
            p.join()
        if not failed:
            failed = [f"{name}: exit code {p.exitcode}"
                      for name, p in procs.items() if p.exitcode != 0]
        if failed:
            raise AssertionError(f"side by side: {failed}")
        out = {}
        for name in names:
            with open(os.path.join(d, f"{name}.pkl"), "rb") as f:
                out[name] = pickle.load(f)
        return out, time.time() - t0


# phases of the serial order that run in the learning block instead, each
# in a process of its own, under their ``[time]`` names: none draws from a
# global random state (``side_by_side`` refuses a child that does) or hands
# a later phase anything but its sum-tree launches. name -> (the phase, its
# arguments, the count of ``phase_learning_block``'s launches its own join,
# or None where it returns none)
BLOCK_PHASES = {
    "card-vs-cpu onpolicy": (phase_card_vs_cpu_onpolicy, (), None),
    "onpolicy": (phase_onpolicy, (), "onpolicy"),
    "card-vs-cpu marl onpolicy": (phase_card_vs_cpu_marl_onpolicy, (), None),
    **{f"marl onpolicy {label}": (phase_marl_onpolicy, (label,), "onpolicy")
       for label in MARL_ONPOLICY_PATHS},
}


def block_phase(name: str) -> dict:
    """The phase ``name`` of ``BLOCK_PHASES``, unchanged: its sum-tree
    launches (0 where it returns none) and a line to log."""
    fn, args, _ = BLOCK_PHASES[name]
    t0 = time.time()
    out = fn(*args)
    launches = out["launches"] if isinstance(out, dict) else out or 0
    return dict(launches=launches, line=f"[phase {name}] passed in "
                f"{time.time() - t0:.1f} s, sumtree launches {launches}")


def block_task(name: str) -> dict:
    """One process of ``phase_learning_block``: the learning check
    ``name`` of ``LEARNING_CHECKS``, the phase ``name`` of
    ``BLOCK_PHASES``, else the recipe ``name``."""
    if name in LEARNING_CHECKS:
        return phase_learning(name)
    return block_phase(name) if name in BLOCK_PHASES else recipe(name)


def phase_learning_block() -> dict:
    """Every check of ``LEARNING_CHECKS``, every phase of ``BLOCK_PHASES``
    and every recipe of ``RECIPE_TABLES`` at once (``side_by_side``), each
    ``phase_learning``, phase or ``recipe`` unchanged in a process of its
    own on the card. Logs each line and seconds; fails if one failed, a
    recipe took more than ``N5_TIMEOUT_S``, or one moved a global random
    state (the phases after the block then get the states a serial run
    would have left them). Returns the sum-tree launches of the on-policy
    checks and phases and of the multi-agent checks ("onpolicy", "marl")
    and of each table of recipes (its name in ``RECIPE_TABLES``), and under
    "walker" each walker recipe's K2 and K3 launches, by its tag."""
    from freerl_tpu_torch.train import golden

    tables = {tag: name for name, table, _ in RECIPE_TABLES
              for tag in getattr(golden, table)}
    runs, wall = side_by_side(block_task, list(LEARNING_CHECKS) +
                              list(BLOCK_PHASES) + list(tables))
    launches = dict(onpolicy=0, marl=0,
                    **{name: 0 for name, _, _ in RECIPE_TABLES})
    moved, late = {}, {}
    for name, rec in runs.items():
        log(rec["out"]["line"])
        kind = ("recipe" if name in tables else "phase"
                if name in BLOCK_PHASES else "learning")
        log(f"[time] {kind} {name}: {rec['seconds']:.1f} s (side by side)")
        driver = (tables.get(name) or BLOCK_PHASES.get(name, (0, 0, None))[2]
                  or LEARNING_CHECKS.get(name, {}).get("driver"))
        if driver in launches:
            launches[driver] += rec["out"]["launches"]
        if "k2" in rec["out"]:
            launches.setdefault("walker", {})[name] = (rec["out"]["k2"],
                                                       rec["out"]["k3"])
        if name in tables and rec["seconds"] > N5_TIMEOUT_S:
            late[name] = rec["seconds"]
        if rec["moved"]:
            moved[name] = rec["moved"]
    longest = max(runs[name]["seconds"] for name in LEARNING_CHECKS)
    log(f"[time] learning block: {wall:.1f} s for {len(LEARNING_CHECKS)} "
        f"checks, {len(BLOCK_PHASES)} phases and {len(tables)} recipes side "
        f"by side, "
        f"{wall / longest:.2f}x the longest check ({longest:.1f} s); the "
        f"checks' and recipes' own times sum to "
        f"{sum(rec['seconds'] for rec in runs.values()):.1f} s")
    if late:
        raise AssertionError(f"recipes took over {N5_TIMEOUT_S:.0f} s: "
                             f"{late}")
    if moved:
        raise AssertionError(f"checks or recipes drew from the global "
                             f"random states: {moved}")
    return launches


# ---------------------------------------------------------------------------
# slice 8: data-parallel training on torch.distributed
# ---------------------------------------------------------------------------
DP_RANKS = 2


class DeviceRawLog(RawLog):
    """``RawLog`` around an env that steps on the device."""

    def vec_step_auto_reset(self, state, action, generator, num_envs):
        from freerl_tpu_torch.envs.base import vec_step_auto_reset

        out = vec_step_auto_reset(self.env, state, action, generator,
                                  num_envs)
        self.raw.append((out.reward, out.episode_done))
        return out


def replicated_flat(state) -> torch.Tensor:
    """Every float tensor of an algo state that the ranks keep alike (nets,
    targets, Adam moments, normalizer stats), flat on the CPU; the per-env
    leaves, one slice per rank, are left out."""
    from freerl_tpu_torch.distributed.dp import (_get, per_env_paths,
                                                 state_tensors)

    per_env = {id(_get(state, p)) for p in per_env_paths(state)}
    return torch.cat([t.detach().reshape(-1).cpu()
                      for t in state_tensors(state)
                      if t.is_floating_point() and id(t) not in per_env])


def dp_run(run, algo) -> dict:
    """``run()`` (a driver with ``mesh=``) with the sum-tree kernel's count
    set to 0 just before and read just after."""
    from freerl_tpu_torch.ops import sumtree

    torch.cuda.synchronize()
    sumtree.launches = 0
    t0 = time.time()
    state, returns, info = run()
    launches = sumtree.launches
    torch.cuda.synchronize()
    check_metrics("dp", algo)
    if not np.isfinite(returns).all():
        raise AssertionError("dp: non-finite episode return")
    return dict(state=state, returns=returns, info=info, launches=launches,
                flat=replicated_flat(state), seconds=time.time() - t0)


def dp_paths(mesh) -> dict:
    """The three data-parallel paths on this rank: the main path (DQN +
    PER (tree) on LunarLander-v2 at full width: 1024 envs in all, replay
    1e6 and PER 2^20 per rank, batch 256 per rank, 128 vector steps through
    ``train_offpolicy(mesh=)``), MADDPG on simple_spread_v3 (defaults, 256
    envs, 50 vector steps, ``train_marl(mesh=)``) and PPO on CartPole-v1
    with obs_norm, reward_scaling and adv_norm (1024 envs, T 16, two
    iterations, ``train_onpolicy(mesh=)``)."""
    from freerl_tpu_torch.algos import (DQN, MADDPG, PPO, DQNConfig,
                                        MADDPGConfig, PPOConfig)
    from freerl_tpu_torch.distributed.dp import pmean
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.train import (MARLConfig, OffPolicyConfig,
                                        OnPolicyConfig, train_marl,
                                        train_offpolicy, train_onpolicy)

    dev, out = mesh.device, {}
    env = DeviceRawLog(make("LunarLander-v2", device=dev))
    algo = probe(DQN)(env.dim_info, DQNConfig(
        buffer_size=1_000_000, batch_size=256, hidden=(128,), per=True,
        per_sampler="tree", axis_name="dp"), device=dev)
    cfg = OffPolicyConfig(seed=0, num_envs=1024, start_steps=500,
                          chunk_size=64, max_env_steps=1024 * 128,
                          max_episodes=10**9)
    r = dp_run(lambda: train_offpolicy(env, algo, cfg, mesh=mesh), algo)
    if r["launches"] != r["info"]["updates"] or not r["launches"]:
        raise AssertionError(f"dp: sumtree kernel launched {r['launches']} "
                             f"times for {r['info']['updates']} learner "
                             f"steps on rank {mesh.rank}")
    # the learner step's gradient all-reduce alone (8-128-4: 1,668 floats)
    grads = [p.detach().clone() for p in r["state"].net.parameters()]
    for _ in range(10):
        pmean(grads, "dp")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        pmean(grads, "dp")
    torch.cuda.synchronize()
    r.update(steps=record_steps(env.raw),
             allreduce_ms=(time.perf_counter() - t0) / 200 * 1e3,
             grad_floats=sum(g.numel() for g in grads),
             learn_ms=float(np.mean([s.elapsed_time(e)
                                     for s, e in algo.events])))
    out["dqn"] = r

    spread = DeviceRawLog(make("simple_spread_v3", device=dev))
    maddpg = probe(MADDPG)(spread, MADDPGConfig(axis_name="dp"), device=dev)
    out["maddpg"] = r = dp_run(lambda: train_marl(spread, maddpg, MARLConfig(
        num_envs=256, chunk_size=25, max_env_steps=256 * 50,
        max_episodes=10**9), mesh=mesh), maddpg)
    r["steps"] = record_steps(spread.raw)

    cart = DeviceRawLog(make("CartPole-v1", device=dev))
    ppo = onpolicy_probe(PPO)(cart.dim_info, PPOConfig(
        horizon=1024 * 16, num_envs=1024, minibatch_size=256, K_epochs=2,
        adv_norm=True, obs_norm=True, reward_scaling=True, axis_name="dp"),
        device=dev)
    out["ppo"] = r = dp_run(lambda: train_onpolicy(cart, ppo, OnPolicyConfig(
        num_envs=1024, horizon=1024 * 16, max_env_steps=1024 * 16 * 2,
        max_episodes=10**9), mesh=mesh), ppo)
    r["steps"] = record_steps(cart.raw)
    for k in out:
        out[k].pop("state")
    return out


def dp_card_vs_cpu(mesh, mesh_cpu) -> dict:
    """One sharded update of DQN (PER weights, full width), PPO (CartPole,
    the three normalizer tricks, 2x128, T 16 x 64 envs) and MADDPG (spread,
    defaults) on this rank's card and on its CPU, from the same params and
    this rank's batch: the card's ranks all-reduce over ``dp``, the CPU's
    over ``dp_cpu``. Every net is held to the CPU's at 1e-5, bar one
    element in 10,000 and none past the lr (``held``)."""
    from freerl_tpu_torch.algos import (DQN, MADDPG, PPO, DQNConfig,
                                        LearnDraws, MADDPGConfig, PPOConfig,
                                        Rollout)
    from freerl_tpu_torch.core.types import DimInfo, Transition
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.train.marl import example_transition

    rng = np.random.default_rng(1000 + mesh.rank)
    devs = {"cpu": ("cpu", "dp_cpu"), "cuda": (mesh.device, "dp")}
    errs = {}

    def pair(make_algo, nets):
        algos = {k: make_algo(dev, axis) for k, (dev, axis) in devs.items()}
        states = {k: a.init(torch.Generator(device=devs[k][0]).manual_seed(0))
                  for k, a in algos.items()}
        for name in nets:
            for i, net in enumerate(getattr(states["cpu"], name)
                                    if isinstance(getattr(states["cpu"],
                                                          name), list)
                                    else [getattr(states["cpu"], name)]):
                dst = getattr(states["cuda"], name)
                (dst[i] if isinstance(dst, list) else dst).load_state_dict(
                    net.state_dict())
        return algos, states

    def moved(x, dev):
        return dataclasses.replace(x, **{f.name: getattr(x, f.name).to(dev)
                                         for f in dataclasses.fields(x)})

    # DQN with PER weights
    algos, states = pair(lambda d, a: DQN(
        DimInfo(obs_dim=8, action_dim=4),
        DQNConfig(hidden=(128,), per=True, per_sampler="tree",
                  axis_name=a), device=d), ("net", "target_net"))
    batch = Transition(
        obs=torch.from_numpy(rng.normal(size=(256, 8)).astype(np.float32)),
        action=torch.from_numpy(rng.integers(0, 4, 256).astype(np.int32)),
        reward=torch.from_numpy(rng.normal(size=256).astype(np.float32)),
        next_obs=torch.from_numpy(rng.normal(size=(256, 8)).astype(
            np.float32)),
        done=torch.from_numpy(rng.random(256) < 0.1),
        episode_done=torch.from_numpy(rng.random(256) < 0.1))
    w = torch.from_numpy(rng.random(256).astype(np.float32))
    for k, (dev, _) in devs.items():
        algos[k].update(states[k], moved(batch, dev), None, w.to(dev))
    held("dp DQN PER update", params_of(states["cpu"].net),
         params_of(states["cuda"].net), errs, lr=1e-3)

    # PPO with obs_norm, reward_scaling and adv_norm
    algos, states = pair(lambda d, a: PPO(
        DimInfo(obs_dim=4, action_dim=2),
        PPOConfig(num_envs=64, minibatch_size=256, K_epochs=2,
                  adv_norm=True, obs_norm=True, reward_scaling=True,
                  axis_name=a), device=d), ("actor", "critic"))
    t, n = 16, 64
    roll = Rollout(
        obs=torch.from_numpy(rng.normal(size=(t, n, 4)).astype(np.float32)),
        action=torch.from_numpy(rng.integers(0, 2, (t, n))),
        log_pi=torch.from_numpy(
            (rng.normal(size=(t, n)) * 0.1 - 0.7).astype(np.float32)),
        reward=torch.ones(t, n),
        next_obs=torch.from_numpy(rng.normal(size=(t, n, 4)).astype(
            np.float32)),
        done=torch.from_numpy(rng.random((t, n)) < 0.05),
        adv_done=torch.from_numpy(rng.random((t, n)) < 0.05))
    perms = torch.stack([torch.randperm(t * n, generator=torch.Generator()
                                        .manual_seed(e)) for e in range(2)])
    for k, (dev, _) in devs.items():
        r = moved(roll, dev)
        algos[k].process_obs(states[k], r.next_obs[0], r.next_obs[0])
        algos[k].process_reward(states[k], r.reward[0], r.adv_done[0])
        algos[k].update(states[k], r, perms.to(dev))
    held("dp PPO obs_rms", torch.cat([states["cpu"].obs_rms.var,
                                      states["cpu"].obs_rms.mean]),
         torch.cat([states["cuda"].obs_rms.var,
                    states["cuda"].obs_rms.mean]), errs, rel=True)
    held("dp PPO update", params_of(states["cpu"].actor,
                                    states["cpu"].critic),
         params_of(states["cuda"].actor, states["cuda"].critic), errs,
         lr=1e-3)

    # MADDPG on spread
    envs = {k: make("simple_spread_v3", device=dev)
            for k, (dev, _) in devs.items()}
    algos, states = pair(lambda d, a: MADDPG(
        envs["cpu" if d == "cpu" else "cuda"], MADDPGConfig(axis_name=a),
        device=d), ("actors", "actor_targets", "critics", "critic_targets"))
    rows, a, di = 1024, 3, envs["cpu"].dim_info
    data = dict(
        obs=rng.normal(size=(rows, a, di.obs_dim)).astype(np.float32),
        action=rng.uniform(-1, 1, (rows, a, di.action_dim)).astype(
            np.float32),
        reward=rng.normal(size=(rows, a)).astype(np.float32),
        next_obs=rng.normal(size=(rows, a, di.obs_dim)).astype(np.float32),
        done=rng.random(rows) < 0.1, episode_done=rng.random(rows) < 0.1)
    idx = torch.from_numpy(rng.integers(0, rows, (a, 256)))
    for k, (dev, _) in devs.items():
        buf = algos[k].make_buffer(example_transition(envs[k]),
                                   num_envs=rows).add(Transition(**{
                                       f: torch.from_numpy(v).to(dev)
                                       for f, v in data.items()}))
        algos[k].update(states[k], buf, LearnDraws(idx=idx.to(dev)))
    held("dp MADDPG update",
         params_of(*states["cpu"].actors, *states["cpu"].critics),
         params_of(*states["cuda"].actors, *states["cuda"].critics), errs,
         lr=5e-4)
    return errs


def dp_rank(rank: int, d: str) -> None:
    """One rank of the ``dp`` and ``card-vs-cpu slice 8`` phases (a spawned
    process): join the group through a file in ``d``, build the card's mesh
    ``dp`` (gloo: the ranks share one card) and the CPU's mesh ``dp_cpu``,
    run both phases, save what the parent checks as ``rank<r>.pt``."""
    import datetime

    from freerl_tpu_torch.distributed import multihost
    from freerl_tpu_torch.distributed.dp import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    timeout = datetime.timedelta(seconds=300)
    multihost.initialize(f"file://{d}/rendezvous", DP_RANKS, rank,
                         timeout=timeout)
    try:
        mesh = make_mesh(axis="dp", backend="gloo", device="cuda",
                         timeout=timeout)
        mesh_cpu = make_mesh(axis="dp_cpu", device="cpu", timeout=timeout)
        t0 = time.time()
        out = dict(paths=dp_paths(mesh), device=str(mesh.device))
        out["paths_s"] = time.time() - t0
        t0 = time.time()
        out["card_vs_cpu"] = dp_card_vs_cpu(mesh, mesh_cpu)
        out["card_vs_cpu_s"] = time.time() - t0
        torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def phase_dp() -> dict:
    """Two ranks on the one card (spawned, gloo), each on its half of the
    envs: the main path, MADDPG and PPO through the drivers' ``mesh=``,
    then the card-against-CPU sharded updates. The parent checks that
    every replicated tensor is bit-equal across the ranks, that B1 ran
    once per learner step on each rank of the main path and never on the
    others, and that the merged record equals the ranks' raw rewards
    merged by (completion step, rank). Returns B1's launches per rank and
    the card-against-CPU errors."""
    import multiprocessing as mp
    import tempfile

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        procs = [ctx.Process(target=dp_rank, args=(r, d))
                 for r in range(DP_RANKS)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * DP_RANKS:
            raise AssertionError(f"dp: rank exit codes {codes}")
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"),
                            weights_only=False) for r in range(DP_RANKS)]
        wall = time.time() - t0
    for name in ("dqn", "maddpg", "ppo"):
        runs = [rk["paths"][name] for rk in ranks]
        if not all(torch.equal(runs[0]["flat"], r["flat"]) for r in runs):
            raise AssertionError(f"dp {name}: the ranks' states differ")
        want = np.concatenate([s for step in zip(*(r["steps"] for r in runs))
                               for s in step])
        returns = runs[0]["returns"]
        if not (np.array_equal(returns, want)
                and all(np.array_equal(returns, r["returns"])
                        for r in runs)):
            raise AssertionError(f"dp {name}: the merged record is not the "
                                 f"ranks' raw rewards merged by step")
        launches = [r["launches"] for r in runs]
        if name != "dqn" and any(launches):
            raise AssertionError(f"dp {name}: sumtree launches {launches}")
        info = runs[0]["info"]
        log(f"[dp {name}] {DP_RANKS} ranks on {ranks[0]['device']}: "
            f"{info['env_steps']} env steps, {info.get('updates', '')}"
            f"{info.get('iterations', '')} updates, {info['episodes']} "
            f"episodes in {info['elapsed_s']:.2f} s: "
            f"{info['env_steps_per_s']:.0f} env-steps/s in all (two ranks "
            f"sharing one card: no scaling result), state bit-equal across "
            f"ranks ({runs[0]['flat'].numel()} floats), record == raw "
            f"rewards merged ({len(returns)} episodes), sumtree launches "
            f"per rank {launches}")
    dqn = [rk["paths"]["dqn"] for rk in ranks]
    log(f"[dp dqn] learner step {[round(r['learn_ms'], 3) for r in dqn]} ms "
        f"per rank; gradient all-reduce ({dqn[0]['grad_floats']} float32, "
        f"gloo through the host) {[round(r['allreduce_ms'], 4) for r in dqn]}"
        f" ms per rank; paths {[round(rk['paths_s'], 1) for rk in ranks]} s, "
        f"card vs CPU {[round(rk['card_vs_cpu_s'], 1) for rk in ranks]} s, "
        f"spawn to join {wall:.1f} s")
    for r, rk in enumerate(ranks):
        log(f"[card-vs-cpu slice 8] rank {r}: " + "; ".join(
            f"{k} max abs err {v[0]:.3g}, {v[1]} past 1e-5"
            for k, v in rk["card_vs_cpu"].items()))
    return dict(launches=[r["launches"] for r in dqn],
                updates=[r["info"]["updates"] for r in dqn])


def phase_nccl_one_rank() -> None:
    """A one-rank NCCL group in this process (the only NCCL run one card
    allows): a DQN update with ``axis_name`` bit-equal to the same update
    with no mesh."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from freerl_tpu_torch.algos import DQN, DQNConfig
    from freerl_tpu_torch.core.types import DimInfo, Transition
    from freerl_tpu_torch.distributed.dp import make_mesh, release

    rng = np.random.default_rng(7)
    batch = Transition(
        obs=torch.from_numpy(rng.normal(size=(256, 8)).astype(np.float32)),
        action=torch.from_numpy(rng.integers(0, 4, 256).astype(np.int32)),
        reward=torch.from_numpy(rng.normal(size=256).astype(np.float32)),
        next_obs=torch.from_numpy(rng.normal(size=(256, 8)).astype(
            np.float32)),
        done=torch.from_numpy(rng.random(256) < 0.1),
        episode_done=torch.from_numpy(rng.random(256) < 0.1))
    batch = dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).cuda()
        for f in dataclasses.fields(batch)})
    di = DimInfo(obs_dim=8, action_dim=4)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            mesh = make_mesh(axis="nccl1", backend="nccl", device="cuda")
            nets = []
            for axis in (None, "nccl1"):
                algo = DQN(di, DQNConfig(hidden=(128,), axis_name=axis),
                           device="cuda")
                state = algo.init(torch.Generator("cuda").manual_seed(0))
                for _ in range(3):
                    algo.update(state, batch)
                nets.append(params_of(state.net, state.target_net))
            release(mesh)
        finally:
            dist.destroy_process_group()
    if not torch.equal(*nets):
        raise AssertionError("one-rank NCCL: the update with axis_name "
                             "differs from the update with no mesh")
    log(f"[card-vs-cpu slice 8] one-rank NCCL: three DQN updates with "
        f"axis_name bit-equal to three with no mesh ({nets[0].numel()} "
        f"floats)")


def phase_golden() -> None:
    """``golden.regenerate`` on a 25-episode CartPole recipe on the card,
    into a temporary directory: a (1, >=25) finite stack."""
    import tempfile

    from freerl_tpu_torch.train import golden

    spec = golden.GoldenSpec(
        "CartPole-v1", "DQN_1_seed",
        "DQN_file/learning_curves/CartPole-v1/DQN_3_seed.npy",
        regen=("--algo", "DQN", "--env_name", "CartPole-v1",
               "--max_episodes", "25", "--num_envs", "4",
               "--buffer_size", "2048", "--seed", "{seed}"),
        regen_seeds=(0,))
    with tempfile.TemporaryDirectory() as d:
        saved_root = golden.OURS_ROOT
        golden.OURS_ROOT = d
        try:
            path = golden.regenerate(spec, results_root=d, device="cuda")
        finally:
            golden.OURS_ROOT = saved_root
        stacked = np.load(os.path.join(d, "CartPole-v1", "DQN_1_seed.npy"))
    if not (stacked.shape[0] == 1 and stacked.shape[1] >= 25
            and np.isfinite(stacked).all()):
        raise AssertionError(f"golden: stack {stacked.shape}")
    log(f"[golden] regenerate on the card: stack {stacked.shape}, returns "
        f"{stacked.min():.1f} .. {stacked.max():.1f} (smoothed), wrote "
        f"{os.path.basename(path)}")


BENCH_ENVS, BENCH_CHUNK, BENCH_CHUNKS = 4096, 256, 2


def phase_bench() -> int:
    """The port's bench (``freerl_tpu_torch/bench.py``): ``bench_dqn`` at
    the headline size (4096 envs, chunk 256) for 2 measured chunks, in this
    process; then ``python -m freerl_tpu_torch.bench`` with
    ``BENCH_SKIP_EXTRA=1 BENCH_CHUNKS=2`` in a subprocess, whose last line
    must be the bench's JSON. Returns B1's launches (0: uniform replay)."""
    import math

    from freerl_tpu_torch import bench
    from freerl_tpu_torch.ops import sumtree

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sumtree.launches = 0
    run = bench.bench_dqn(num_envs=BENCH_ENVS, chunk=BENCH_CHUNK,
                          measure_chunks=BENCH_CHUNKS, device="cuda")
    launches = sumtree.launches
    peak = torch.cuda.max_memory_allocated() / 2**20
    want = BENCH_CHUNKS * BENCH_CHUNK * BENCH_ENVS
    if run.env_steps != want or not math.isfinite(run.env_steps_per_s):
        raise AssertionError(f"bench: {run} (expected {want} env steps)")
    if launches:
        raise AssertionError(f"bench: uniform replay launched the sum-tree "
                             f"kernel {launches} times")
    log(f"[bench] bench_dqn {BENCH_ENVS} envs x chunk {BENCH_CHUNK} x "
        f"{BENCH_CHUNKS} chunks: {run.env_steps} env steps in "
        f"{run.elapsed_s:.3f} s, {run.env_steps_per_s:.1f} env-steps/s, "
        f"peak memory {peak:.1f} MiB, sumtree launches {launches}")

    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_SKIP_EXTRA="1", BENCH_CHUNKS=str(BENCH_CHUNKS))
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "freerl_tpu_torch.bench"],
                          capture_output=True, text=True, timeout=600,
                          env=env,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"bench: python -m freerl_tpu_torch.bench "
                             f"exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    if (set(line) != {"metric", "value", "unit", "vs_baseline", "extra"}
            or line["metric"] != "dqn_lunarlander_env_steps_per_s"
            or line["vs_baseline"] is not None or line["extra"]
            or not (math.isfinite(line["value"]) and line["value"] > 0)):
        raise AssertionError(f"bench: last line {line}")
    log(f"[bench] python -m freerl_tpu_torch.bench (BENCH_SKIP_EXTRA=1 "
        f"BENCH_CHUNKS={BENCH_CHUNKS}) in {time.time() - t0:.1f} s: "
        f"{json.dumps(line)} | {proc.stderr.strip().splitlines()[-1]}")
    return launches


def phase_per_bench() -> int:
    """``scripts/torch_per_bench.py`` at the main path's PER size (2^20,
    batch 256, 200 timed cycles per sampler): B1 once per ``sample`` on
    ``tree``, never on ``cumsum`` (the script checks it). Returns B1's
    launches."""
    from freerl_tpu_torch.ops import sumtree
    from scripts import torch_per_bench

    sumtree.launches = 0
    out = torch_per_bench.run(capacity=1 << MAIN_CAP_POW, batch=MAIN_BATCH,
                              iters=200, device="cuda")
    us, n, launches = (out["cycle_us"], out["samples"],
                       out["sumtree_launches"])
    log(f"[per bench] capacity {out['capacity']}, batch {out['batch']}: "
        f"tree (B1) {us['tree']:.1f} us per add+sample+update cycle, "
        f"cumsum {us['cumsum']:.1f} us; sumtree launches {launches} for "
        f"{n} samples")
    return launches["tree"]


def optimizers_of(x) -> list:
    """Every optimizer of an algo state, through dataclasses, lists,
    tuples and dicts (the walk of ``dp.state_tensors``)."""
    if isinstance(x, torch.optim.Optimizer):
        return [x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [o for v in x for o in optimizers_of(v)]
    return []


def with_cudnn_tf32(run):
    """``run`` with cuDNN's TF32 at torch's default (on), what a user gets;
    the setting is put back after it."""
    def wrapped():
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            return run()
        finally:
            torch.backends.cudnn.allow_tf32 = saved
    return wrapped


def determinism_runs() -> dict:
    """Each config's run on the card, through the user's entry points:
    ``(state, record, info)``. First the JAX package's
    tests/test_determinism.py configs (DQN on CartPole-v1, seed 7; PPO on
    Pendulum-v1, seed 3) and the main path (DQN + PER tree on
    LunarLander-v2 at full width, 1024 envs, 64 vector steps); then one
    config per algorithm class the other phases train, at their widths
    (nets, batches, replay sizes, populations), cut in envs and steps to a
    few chunks or one iteration with learner steps after the warm-up. The
    pixel configs (pixel DQN with the small trunk, conv PPO, one DQN update
    through the nature trunk at (84, 84, 4), batch 64) run with TF32 off,
    as ``main`` sets it, and again with cuDNN's TF32 at torch's default."""
    from freerl_tpu_torch.algos import (DQN, GAIL, PPO, CEMGD3PG, DQNConfig,
                                        Envelope, GAILConfig, PPOConfig,
                                        REINFORCEConfig, collect_expert_data,
                                        train_cem_gd3pg, train_gail)
    from freerl_tpu_torch.core.types import DimInfo, Transition
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.train import (HERConfig, MARLConfig,
                                        OffPolicyConfig, OnPolicyConfig,
                                        train_her, train_marl,
                                        train_offpolicy, train_onpolicy)

    def dqn_cartpole():
        env = make("CartPole-v1", device="cuda")
        algo = DQN(env.dim_info, DQNConfig(buffer_size=4096, batch_size=32),
                   device="cuda")
        return train_offpolicy(env, algo, OffPolicyConfig(
            seed=7, num_envs=4, max_episodes=40, start_steps=200,
            chunk_size=64))

    def ppo_pendulum():
        env = make("Pendulum-v1", device="cuda")
        algo = PPO(env.dim_info, PPOConfig(horizon=256, K_epochs=2,
                                           num_envs=4), device="cuda")
        return train_onpolicy(env, algo, OnPolicyConfig(
            seed=3, num_envs=4, max_episodes=16, horizon=256))

    def main_path():
        env = make("LunarLander-v2", device="cuda")
        algo = DQN(env.dim_info, DQNConfig(
            per=True, per_sampler="tree", buffer_size=1_000_000,
            batch_size=256), device="cuda")
        return train_offpolicy(env, algo, OffPolicyConfig(
            seed=0, num_envs=1024, chunk_size=64, max_env_steps=1024 * 64,
            max_episodes=10**9))

    def offpolicy(env_name, algo_name, algo_cfg, num_envs, chunk, chunks,
                  start_steps=500, dis_to_con=False):
        def run():
            env = make(env_name, dis_to_con=dis_to_con, device="cuda")
            algo = algo_classes(algo_name)[0](env.dim_info, algo_cfg,
                                              device="cuda")
            return train_offpolicy(env, algo, OffPolicyConfig(
                seed=0, num_envs=num_envs, start_steps=start_steps,
                chunk_size=chunk, max_env_steps=num_envs * chunk * chunks,
                max_episodes=10**9))
        return run

    def onpolicy(env_name, algo_name, algo_cfg, num_envs, t):
        def run():
            env = make(env_name, device="cuda")
            algo = algo_classes(algo_name)[0](env.dim_info, algo_cfg,
                                              device="cuda")
            return train_onpolicy(env, algo, OnPolicyConfig(
                seed=0, num_envs=num_envs, horizon=num_envs * t,
                max_env_steps=num_envs * t, max_episodes=10**9))
        return run

    def marl(label, num_envs=128, steps=8):
        def run():
            env_name, algo_name, extra = MARL_PATHS[label][:3]
            env = marl_env(env_name, "cuda")
            cls, cfg_cls = algo_classes(algo_name)
            algo = cls(env, cfg_cls(num_envs=num_envs, **extra),
                       device="cuda")
            return train_marl(env, algo, MARLConfig(
                seed=0, num_envs=num_envs, start_steps=500, chunk_size=4,
                max_env_steps=num_envs * steps, max_episodes=10**9))
        return run

    def marl_onpolicy(label):
        def run():
            env_name, algo_name, extra, t = MARL_ONPOLICY_PATHS[label][:4]
            num_envs = 64 if t < 10 else 32     # horizon 256 / 320
            env = marl_env(env_name, "cuda")
            algo = marl_onpolicy_algo(algo_name, env, "cuda",
                                      num_envs=num_envs,
                                      horizon=num_envs * t, **extra)
            return train_onpolicy(env, algo, OnPolicyConfig(
                seed=0, num_envs=num_envs, horizon=num_envs * t,
                max_env_steps=num_envs * t, max_episodes=10**9))
        return run

    def her():
        env = make("GoalPendulum-v1", device="cuda")
        cls, cfg_cls = algo_classes("DDPG")
        algo = cls(env.dim_info, cfg_cls(batch_size=256), device="cuda")
        return train_her(env, algo, HERConfig(
            num_envs=64, max_episodes=64, updates_per_episode=20))

    def gail():
        env = make("Pendulum-v1", device="cuda")
        learner = GAIL(env.dim_info,
                       PPOConfig(horizon=256, minibatch_size=64, num_envs=8,
                                 actor_lr=1e-4, adv_norm=True,
                                 orthogonal_init=True),
                       GAILConfig(d_steps_per_iter=1, d_lr=1e-4),
                       device="cuda")
        expert = collect_expert_data(env, pendulum_expert, 2048, seed=1)
        state, record, _ = train_gail(env, learner, expert, num_iterations=1,
                                      num_envs=8, seed=0)
        return (state, expert), record, {}

    def cem():
        env = make("Pendulum-v1", device="cuda")
        return train_cem_gd3pg(env, CEMGD3PG(env.dim_info, device="cuda"),
                               max_episodes=2, seed=0,
                               updates_per_episode=20)

    def envelope():
        env = make("deep-sea-treasure-v0", device="cuda")
        algo = Envelope(env.dim_info, env.reward_dim, device="cuda")
        return train_offpolicy(env, algo, OffPolicyConfig(
            seed=0, num_envs=256, start_steps=1000, chunk_size=8,
            max_env_steps=256 * 16, max_episodes=10**9))

    pixel_shape = make("PixelCartPole-v1", device="cpu").obs_shape

    def dqn_nature_update():
        shape, batch = (84, 84, 4), 64
        obs_dim = int(np.prod(shape))
        algo = DQN(DimInfo(obs_dim=obs_dim, action_dim=2), DQNConfig(
            obs_shape=shape, conv_arch="nature", cnn_features=512,
            batch_size=batch), device="cuda")
        g = torch.Generator(device="cuda").manual_seed(0)
        state = algo.init(g)
        done = torch.rand(batch, generator=g, device="cuda") < 0.1
        b = Transition(
            obs=torch.rand(batch, obs_dim, generator=g, device="cuda"),
            action=torch.randint(0, 2, (batch,), generator=g,
                                 device="cuda"),
            reward=torch.randn(batch, generator=g, device="cuda"),
            next_obs=torch.rand(batch, obs_dim, generator=g, device="cuda"),
            done=done, episode_done=done)
        state, _, _ = algo.update(state, b)
        grads = torch.cat([p.grad.flatten() for p in state.net.parameters()])
        return state, grads.cpu().numpy(), {}

    family = DQNConfig(double=True, dueling=True, n_step=3)
    pixel = {
        "pixel DQN small trunk PixelCartPole-v1": offpolicy(
            "PixelCartPole-v1", "DQN", DQNConfig(
                buffer_size=100_000, batch_size=64, obs_shape=pixel_shape,
                conv_arch="small", cnn_features=128), 64, 16, 2,
            start_steps=256),
        "conv PPO PixelCartPole-v1": onpolicy(
            "PixelCartPole-v1", "PPO", PPOConfig(
                horizon=32 * 16, num_envs=32, obs_shape=pixel_shape), 32, 16),
        "DQN update through the nature trunk": dqn_nature_update,
    }
    runs = {
        "DQN CartPole-v1 seed 7": dqn_cartpole,
        "PPO Pendulum-v1 seed 3": ppo_pendulum,
        "main path DQN + PER tree LunarLander-v2": main_path,
        "DQN uniform LunarLander-v2": offpolicy(
            "LunarLander-v2", "DQN", DQNConfig(
                buffer_size=1_000_000, batch_size=256, hidden=(128,)),
            256, 16, 2),
        "Rainbow LunarLander-v2": offpolicy(
            "LunarLander-v2", "DQN", DQNConfig(
                buffer_size=1_000_000, batch_size=256, hidden=(128,),
                **RAINBOW), 256, 16, 2),
        "DQN double dueling 3-step Pendulum-v1 dis_to_con": offpolicy(
            "Pendulum-v1", "DQN", family, 256, 16, 2, dis_to_con=True),
        **{f"{name} LunarLanderContinuous-v2": offpolicy(
            "LunarLanderContinuous-v2", name,
            algo_classes(name)[1](batch_size=256, num_envs=256), 256, 8, 2)
           for name in ("DDPG", "TD3", "SAC")},
        **{f"discrete {label} CartPole-v1": offpolicy(
            "CartPole-v1", name, algo_classes(name)[1](batch_size=256,
                                                       **extra), 256, 8, 2)
           for label, name, extra in (
               ("DDPG softmax", "DDPG", dict()),
               ("DDPG gumbel", "DDPG", dict(discrete_gumbel=True)),
               ("SAC", "SAC", dict()))},
        "HER DDPG GoalPendulum-v1": her,
        "PPO BipedalWalker-v3": onpolicy(
            "BipedalWalker-v3", "PPO", PPOConfig(horizon=8 * 8, num_envs=8),
            8, 8),
        "REINFORCE CartPole-v1": onpolicy("CartPole-v1", "REINFORCE",
                                          REINFORCEConfig(), 64, 64),
        **{f"marl {label}": marl(label) for label in MARL_PATHS},
        **{f"marl onpolicy {label}": marl_onpolicy(label)
           for label in MARL_ONPOLICY_PATHS},
        "GAIL Pendulum-v1": gail,
        "CEM-GD3PG Pendulum-v1": cem,
        "ENVELOPE deep-sea-treasure-v0": envelope,
    }
    for name, run in pixel.items():
        runs[f"{name} (TF32 off)"] = run
        runs[f"{name} (cuDNN TF32 on)"] = with_cudnn_tf32(run)
    return runs


NORTHSTAR_ENVS, NORTHSTAR_UPB, NORTHSTAR_CHUNKS = 4096, 8, 8


def phase_northstar() -> int:
    """``scripts/torch_northstar.py``'s ``run_point`` at the north-star
    point (4096 envs, 8 updates per vector step) for 8 chunks of 64 vector
    steps: the exact env-step and update counts (learning starts on the
    second vector step, past ``start_steps`` 4096), a finite record, no
    sum-tree launch (uniform replay). Returns B1's launches."""
    from freerl_tpu_torch.ops import sumtree
    from scripts import torch_northstar

    steps = NORTHSTAR_CHUNKS * 64
    sumtree.launches = 0
    returns, row = torch_northstar.run_point(
        NORTHSTAR_ENVS, NORTHSTAR_UPB, steps * NORTHSTAR_ENVS, seed=0,
        device="cuda")
    launches = sumtree.launches
    # updates on every vector step past start_steps (4096 env steps)
    want = (steps * NORTHSTAR_ENVS,
            (steps - 4096 // NORTHSTAR_ENVS) * NORTHSTAR_UPB)
    if (row["env_steps"], row["updates"]) != want:
        raise AssertionError(f"northstar: env_steps {row['env_steps']}, "
                             f"updates {row['updates']}; expected {want}")
    if not (len(returns) == row["episodes"] > 0
            and np.isfinite(returns).all()):
        raise AssertionError(f"northstar: record of {len(returns)} returns "
                             f"for {row['episodes']} episodes, finite "
                             f"{np.isfinite(returns).all()}")
    if launches:
        raise AssertionError(f"northstar: uniform replay launched the "
                             f"sum-tree kernel {launches} times")
    log(f"[northstar] {NORTHSTAR_ENVS} envs x {NORTHSTAR_UPB} updates, "
        f"{NORTHSTAR_CHUNKS} chunks: {row['env_steps']} env steps, "
        f"{row['updates']} updates, {row['episodes']} episodes (final-50 "
        f"{row['final50']}), steady {row['steady_env_steps_per_s']} "
        f"env-steps/s, wall {row['wall_s']} s, matmul precision "
        f"{row['matmul_precision']}, sumtree launches {launches} | "
        f"{row['card']}")
    return launches


def phase_golden_vs_jax() -> None:
    """The parity gate over ``golden.JAX_PARITY``: each committed port curve
    against the JAX curve the row names (the JAX package's committed curve
    of the same stem, or, for a row keyed ``@jax_head``, the JAX package
    rerun at this commit). A row fails the phase if its curve is absent
    (every row has a committed curve), or if its verdict breaks what it is
    held to (``golden.breaks_hold``): it fails its gate and is not held to
    fail, or it is held to fail (an open fault of ``golden.OPEN_FAULTS``, a
    stale reference of ``golden.STALE_REFERENCES``, or a row whose gate,
    not the port, misses, ``golden.UNDERPOWERED``) and passes. A row of
    ``golden.NOT_COMPARABLE`` is printed and held to nothing. The scalar
    gates of ``golden.SCALAR_GATES`` (the GAIL imitation gate), keyed by
    their names, are read from the port's results tree
    (``golden.check_scalar``) and held the same way."""
    from freerl_tpu_torch.train import golden

    wrong = []
    rows = [(golden.row_key(s), golden.check_against_jax(s))
            for s in golden.JAX_PARITY] + [
        (g["name"], golden.check_scalar(g)) for g in golden.SCALAR_GATES]
    for key, r in rows:
        why = (f" (open fault {golden.OPEN_FAULTS[key]})"
               if key in golden.OPEN_FAULTS else
               f" (stale reference, {golden.STALE_REFERENCES[key]})"
               if key in golden.STALE_REFERENCES else
               f" (the gate, not the port, misses: {golden.UNDERPOWERED[key]})"
               if key in golden.UNDERPOWERED else
               f" (not comparable: {golden.NOT_COMPARABLE[key]})"
               if key in golden.NOT_COMPARABLE else "")
        log(f"[golden vs jax] {key}: {r['status']}{why}, ours {r['ours']} "
            f"{r['ours_seeds']}, JAX {r['ref']} {r['ref_seeds']}, slack "
            f"{r['slack']}")
        if (r["status"] not in ("pass", "FAIL")
                or golden.breaks_hold(key, r["status"])):
            wrong.append(f"{key}: {r['status']}{why}")
    if wrong:
        raise AssertionError(f"golden vs jax: {wrong}")


def phase_fixed_reset_starts() -> int:
    """The start every ``--fixed_reset`` row's seeds pin, on the card
    against the CPU (``golden.pinned``: the env built by ``cli.build_env``
    from the row's recipe on each device): the pinned draws bit-equal (the
    JAX package's draw, made on the host) and the start observations within
    ``golden.START_ULPS`` float32 ulps (``golden.same_start``). Returns the
    count of recipes and seeds held."""
    from freerl_tpu_torch.train import golden

    wrong, seen, ulps = [], set(), 0.0
    for row in golden.JAX_PARITY:
        if "--fixed_reset" not in row.regen:
            continue
        for seed in row.regen_seeds:
            argv = [a.format(seed=seed) for a in row.regen]
            if tuple(argv) in seen:
                continue
            seen.add(tuple(argv))
            d_card, o_card = golden.pinned(row, seed, "cuda")
            d_cpu, o_cpu = golden.pinned(row, seed, "cpu")
            ulps = max(ulps, golden.start_ulps(o_card, o_cpu))
            if not (torch.equal(d_card, d_cpu)
                    and golden.same_start(o_card, o_cpu)):
                wrong.append(f"{golden.row_key(row)} seed {seed}: draw "
                             f"{d_card.tolist()} / {d_cpu.tolist()}, start "
                             f"{o_card} / {o_cpu}")
    log(f"[fixed-reset starts] {len(seen)} recipes and seeds: card and CPU "
        f"pin one start in {len(seen) - len(wrong)}; the start observations "
        f"part by at most {ulps:g} float32 ulps")
    if wrong:
        raise AssertionError(f"fixed-reset starts differ: {wrong}")
    return len(seen)


# how ``n5_recipe`` cuts each N=5 recipe: 8 episodes, the driver reading
# its episode count every chunk or iteration; the off-policy drivers run
# chunks of 64 vector steps (512 env steps: one burst of 8 learner steps
# past ``start_steps`` 500), the on-policy ones one iteration; N=30 runs 2
# episodes, its iteration at horizon 256 (15 Adam steps in place of 120)
N5_SMOKE_EPISODES, N5_SMOKE_CHUNK = 8, 64
N5_SMOKE_CUT = {"MAPPO_attention_N30": (2, ["--horizon", "256"])}
# seconds a recipe may take in the block: over four times the longest
# recipe alone
N5_TIMEOUT_S = 300.0


def mpe_widths(env_name: str, n: int) -> tuple:
    """Each agent's observation width in the MPE scenario at ``n`` (the
    spread's agents, the adversary's good agents), as PettingZoo's
    scenarios define it."""
    if env_name == "simple_spread_v3":
        return (4 + 2 * n + 2 * (n - 1) + 2 * (n - 1),) * n
    return (2 * 2 + 2 * n,) + (2 + 2 * 2 + 2 * n,) * n


def n5_recipe(tag: str, device: str = "cuda") -> dict:
    """One recipe of ``golden.N5_RUNS`` on ``device``, cut in depth: the
    env and the algo the port's CLI builds from the recipe's argv
    (``cli.build``: ``--N``, the tricks, the lrs, ``--fixed_reset``,
    ``--reset_seed``) at the tag's first seed, trained by the driver
    ``cli.run`` calls with the recipe's settings, cut as ``N5_SMOKE_CHUNK``
    and ``N5_SMOKE_CUT`` say. The record must
    be ``(episodes, n_agents)`` and finite, the learner must have stepped,
    the env's observations must be ``(envs, n_agents, widest)`` with each
    agent's width ``mpe_widths``, and the run must launch no sum-tree
    kernel. Returns the launches, the run's seconds and a line to log."""
    from freerl_tpu_torch import cli
    from freerl_tpu_torch.train import (MARLConfig, OnPolicyConfig,
                                        train_marl, train_onpolicy)
    from freerl_tpu_torch.train import golden

    _, env_name, _, extra = golden.N5_RUNS[tag]
    seed = golden.N5_SEEDS.get(tag, (0,))[0]
    episodes, cut = N5_SMOKE_CUT.get(tag, (N5_SMOKE_EPISODES, []))
    n = int(extra[extra.index("--N") + 1]) if "--N" in extra else 2
    argv = golden.n5_argv(tag, seed) + cut
    args = cli.parser().parse_args(argv + ["--device", device])
    env, algo = cli.build(args)
    if args.algo in cli.MARL_OFF:
        cfg = MARLConfig(seed=args.seed, num_envs=args.num_envs,
                         max_episodes=episodes, start_steps=args.start_steps,
                         updates_per_burst=args.updates_per_burst,
                         chunk_size=N5_SMOKE_CHUNK, host_sync_every=1)
        run = lambda: train_marl(env, algo, cfg)  # noqa: E731
        steps = "updates"
    else:
        cfg = OnPolicyConfig(seed=args.seed, num_envs=args.num_envs,
                             max_episodes=episodes, horizon=args.horizon,
                             host_sync_every=1)
        run = lambda: train_onpolicy(env, algo, cfg)  # noqa: E731
        steps = "iterations"
    (_, returns, info), launches, seconds = sumtree_count(run, device)
    returns = np.asarray(returns)
    widths = mpe_widths(env_name, n)
    _, obs = env.reset(env.draw_reset(8, torch.Generator(device=device)))
    agents = len(widths)
    if not (returns.shape == (episodes, agents) and info[steps] > 0
            and np.isfinite(returns).all()):
        raise AssertionError(f"{tag}: record {returns.shape}, finite "
                             f"{np.isfinite(returns).all()}, {info}")
    if (tuple(env.agent_obs_dims) != widths
            or tuple(obs.shape) != (8, agents, max(widths))
            or not torch.isfinite(obs).all()):
        raise AssertionError(f"{tag}: observations {tuple(obs.shape)}, "
                             f"widths {env.agent_obs_dims}, expected "
                             f"{widths}")
    if launches:
        raise AssertionError(f"{tag}: {launches} sum-tree launches")
    line = (f"[n5 {tag}] {' '.join(argv)}: {episodes} episodes, "
            f"{info['env_steps']} env steps, {info[steps]} {steps}, record "
            f"{returns.shape}, agent-mean return "
            f"{returns.mean(1).min():.2f} .. {returns.mean(1).max():.2f}, "
            f"observations {tuple(obs.shape)} (widths "
            f"{sorted(set(widths))}), sumtree launches {launches}, "
            f"{seconds:.1f} s")
    return dict(launches=launches, seconds=seconds, line=line)


# how ``spread_recipe`` cuts scripts/train_spread.py's run: whole chunks of
# the recipe (128 vector steps of 16 envs), the first crossing
# ``start_steps`` and the two after it wholly past it
SPREAD_SMOKE_CHUNKS, SPREAD_SMOKE_BINS = 3, 8


def spread_recipe(tag: str, device: str = "cuda") -> dict:
    """The run of ``golden.SPREAD_RUNS`` on ``device``, cut in depth: the
    env and the algo the port's CLI builds from ``golden.spread_argv``
    (the JAX script's config: 16 envs, batch 256, a replay of 1e6, the lrs
    1e-4, random resets), trained by ``train_marl`` with the recipe's
    settings for ``SPREAD_SMOKE_CHUNKS`` chunks. The algo's config must be
    the script's, the record ``(episodes, n_agents)`` and finite, the
    learner must have stepped on every vector step of the last two chunks,
    ``golden.bin_curve`` of the record must give ``SPREAD_SMOKE_BINS``
    finite bin means (its binning is pinned against the committed curve in
    ``tests/test_torch_train_spread.py``), and the run must launch no
    sum-tree kernel. Returns
    the launches, the run's seconds and a line to log."""
    from freerl_tpu_torch import cli
    from freerl_tpu_torch.train import MARLConfig, golden, train_marl

    _, _, _, seed, num_envs, chunk, upb = golden.SPREAD_RUNS[tag]
    argv = golden.spread_argv(tag, seed)
    args = cli.parser().parse_args(argv + ["--device", device])
    env, algo = cli.build(args)
    want = dict(batch_size=256, buffer_size=1_000_000, actor_lr=1e-4,
                critic_lr=1e-4, alpha_lr=1e-4, num_envs=num_envs)
    got = {k: getattr(algo.cfg, k) for k in want}
    if got != want or "--fixed_reset" in argv:
        raise AssertionError(f"{tag}: config {got}, expected {want}")
    steps = SPREAD_SMOKE_CHUNKS * chunk * num_envs
    cfg = MARLConfig(seed=args.seed, num_envs=args.num_envs,
                     max_episodes=10**9, max_env_steps=steps,
                     start_steps=args.start_steps,
                     updates_per_burst=args.updates_per_burst,
                     chunk_size=chunk, host_sync_every=1)
    (_, returns, info), launches, seconds = sumtree_count(
        lambda: train_marl(env, algo, cfg), device)
    returns = np.asarray(returns)
    binned = golden.bin_curve(returns, SPREAD_SMOKE_BINS)
    if not (returns.ndim == 2 and returns.shape[1] == env.n_agents
            and len(returns) >= SPREAD_SMOKE_BINS
            and np.isfinite(returns).all()
            and info["env_steps"] == steps
            and 2 * chunk * upb <= info["updates"] < steps // num_envs):
        raise AssertionError(f"{tag}: record {returns.shape}, finite "
                             f"{np.isfinite(returns).all()}, {info}")
    if binned.shape != (SPREAD_SMOKE_BINS,) or not np.isfinite(binned).all():
        raise AssertionError(f"{tag}: bin_curve {binned}")
    if launches:
        raise AssertionError(f"{tag}: {launches} sum-tree launches")
    line = (f"[spread {tag}] {' '.join(argv)}: {SPREAD_SMOKE_CHUNKS} chunks, "
            f"{info['env_steps']} env steps, {info['updates']} updates, "
            f"record {returns.shape}, {SPREAD_SMOKE_BINS} bin means "
            f"{binned.min():.2f} .. {binned.max():.2f}, sumtree launches "
            f"{launches}, {seconds:.1f} s")
    return dict(launches=launches, seconds=seconds, line=line)


# how ``envelope_recipe`` cuts scripts/envelope_seed_sweep.sh's run: whole
# chunks of the driver (256 vector steps of the one env), the second
# crossing ``start_steps`` 500, so the learner steps on the last 268
ENVELOPE_SMOKE_CHUNKS = 3


def envelope_recipe(tag: str, device: str = "cuda") -> dict:
    """The run of ``golden.ENVELOPE_RUNS`` on ``device``, cut in depth: the
    env and the algo the port's CLI builds from ``golden.envelope_argv`` (1
    env, batch 256, a replay of 1e6, 128 preferences an update, epsilon 0.4
    decaying over the 5,000 episodes), trained by ``train_offpolicy`` with
    the recipe's settings for ``ENVELOPE_SMOKE_CHUNKS`` chunks, then the
    100-preference sweep of scripts/torch_envelope_e2e.py on the state it
    reached. The config must be the recipe's, the learner must have
    stepped on every vector step past ``start_steps``, the record must be
    finite, the sweep must give 100 finite returns and a precision, recall
    and CR in [0, 1], and neither may launch the sum-tree kernel. Returns
    the launches, the seconds and a line to log."""
    from freerl_tpu_torch import cli
    from freerl_tpu_torch.train import OffPolicyConfig, golden, train_offpolicy
    from scripts import torch_envelope_e2e as e2e

    _, _, episodes, num_envs, upb, _ = golden.ENVELOPE_RUNS[tag]
    argv = golden.envelope_argv(0, tag=tag)
    args = cli.parser().parse_args(argv + ["--device", device])
    env, algo = cli.build(args)
    want = dict(batch_size=256, buffer_size=1_000_000, weight_num=128,
                epsilon=0.4, epsilon_decay=True, max_episodes=episodes)
    got = {k: getattr(algo.cfg, k) for k in want}
    if got != want or args.num_envs != num_envs:
        raise AssertionError(f"{tag}: config {got}, expected {want}")
    cfg = OffPolicyConfig(seed=args.seed, num_envs=num_envs,
                          max_episodes=10**9, start_steps=args.start_steps,
                          updates_per_burst=upb, host_sync_every=1)
    steps = ENVELOPE_SMOKE_CHUNKS * cfg.chunk_size * num_envs
    cfg = dataclasses.replace(cfg, max_env_steps=steps)
    ws = e2e.preferences()

    def run():
        state, returns, info = train_offpolicy(env, algo, cfg)
        return returns, info, e2e.rollout(algo, state, env, ws)

    (returns, info, (rets, vecs)), launches, seconds = sumtree_count(
        run, device)
    m = e2e.metrics(ws, vecs)
    if not (info["env_steps"] == steps
            and info["updates"] == (steps - args.start_steps) * upb
            and np.isfinite(np.asarray(returns)).all()):
        raise AssertionError(f"{tag}: record {np.shape(returns)}, {info}")
    if not (rets.shape == (100,) and vecs.shape == (100, env.reward_dim)
            and np.isfinite(rets).all()
            and all(0.0 <= m[k] <= 1.0 for k in ("precision", "recall",
                                                   "CR"))):
        raise AssertionError(f"{tag}: sweep {rets.shape}, finite "
                             f"{np.isfinite(rets).all()}, {m}")
    if launches:
        raise AssertionError(f"{tag}: {launches} sum-tree launches")
    line = (f"[envelope {tag}] {' '.join(argv)}: {ENVELOPE_SMOKE_CHUNKS} "
            f"chunks, {info['env_steps']} env steps, {info['updates']} "
            f"updates, {len(returns)} episodes; sweep of 100 preferences: "
            f"mean {rets.mean():.2f}, precision {m['precision']:.2f}, "
            f"recall {m['recall']:.2f}, CR {m['CR']:.2f}; sumtree launches "
            f"{launches}, {seconds:.1f} s")
    return dict(launches=launches, seconds=seconds, line=line)


# how ``pixel_recipe`` cuts scripts/pixel_curve.py's run: whole chunks of
# the recipe (128 vector steps of 8 envs), the first crossing its 1,000
# start steps, so the learner steps on every vector step after the 125th
PIXEL_SMOKE_CHUNKS = 2


def pixel_recipe(tag: str, device: str = "cuda") -> dict:
    """The run of ``golden.PIXEL_RUNS`` on ``device``, cut in depth:
    ``scripts/torch_pixel_curve.train``, the function each seed of the
    script runs, with the JAX script's configs (a replay of 100,000, batch
    64, the 'small' trunk of 128 features, 8 envs, 4 updates a vector step)
    for ``PIXEL_SMOKE_CHUNKS`` chunks. The returns must be finite and in
    [1, 500], the learner must have stepped ``updates_per_burst`` times on
    every vector step past ``start_steps``, and the run must launch no
    sum-tree kernel (the path takes uniform replay). Returns the launches,
    the run's seconds and a line to log."""
    from freerl_tpu_torch.train import golden
    from scripts import torch_pixel_curve as pixel

    _, dqn, off = golden.PIXEL_RUNS[tag]
    num_envs, upb = off["num_envs"], off["updates_per_burst"]
    steps = PIXEL_SMOKE_CHUNKS * off["chunk_size"] * num_envs
    r = pixel.train(0, device, tag, max_episodes=10**9, max_env_steps=steps,
                    host_sync_every=1)
    info, returns, launches = r["info"], r["returns"], r["launches"]
    want = (steps - off["start_steps"] // num_envs * num_envs) // num_envs
    if not (info["env_steps"] == steps and info["updates"] == want * upb
            and len(returns) and np.isfinite(returns).all()
            and returns.min() >= 1 and returns.max() <= 500):
        raise AssertionError(f"{tag}: returns {returns}, {info}")
    if launches:
        raise AssertionError(f"{tag}: {launches} sum-tree launches")
    line = (f"[pixel {tag}] scripts/torch_pixel_curve.py's configs {dqn} "
            f"{off}: {PIXEL_SMOKE_CHUNKS} chunks, {info['env_steps']} env "
            f"steps, {info['updates']} updates, {len(returns)} episodes "
            f"(returns {returns.min():.0f} .. {returns.max():.0f}); sumtree "
            f"launches {launches}, {r['seconds']:.1f} s")
    return dict(launches=launches, seconds=r["seconds"], line=line)


# how ``gail_recipe`` cuts scripts/gail_e2e.py's run: 8 expert episodes, the
# first 4 iterations of 400 env steps (each env ends its first 200-step
# episode in the 4th), and 2 GAIL iterations; the expert set whole
GAIL_SMOKE_EXPERT_EPISODES, GAIL_SMOKE_ITERS = 8, 2


def gail_recipe(tag: str, device: str = "cuda") -> dict:
    """The run of ``golden.GAIL_RUNS`` on ``device``, cut in depth: the four
    stages of ``scripts/torch_gail_e2e.run`` (the expert, its evaluation
    and expert set, GAIL, the held-out evaluation) at
    ``GAIL_SMOKE_EXPERT_EPISODES`` expert episodes and ``GAIL_SMOKE_ITERS``
    GAIL iterations, into a temporary directory. The artifact set must be
    whole, the expert must have taken 4 iterations and GAIL 2, every value
    of the summary and of the curves must be finite, the expert set must
    hold the recipe's pairs, ``golden.check_scalar`` must read the run's
    summary for the gate (pass or FAIL, not missing), and no stage may
    launch the sum-tree kernel. Returns the launches, the seconds and a
    line to log."""
    import tempfile

    from freerl_tpu_torch.train import golden
    from scripts import torch_gail_e2e as e2e

    args = golden.GAIL_RUNS[tag]
    gate = next(g for g in golden.SCALAR_GATES if g["name"] == tag)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as d:
        r = e2e.run(GAIL_SMOKE_EXPERT_EPISODES, GAIL_SMOKE_ITERS,
                    args["n_expert_transitions"], args["seed"],
                    os.path.join(d, "gail"), device, log=lambda msg: None)
        files = sorted(os.listdir(r["run_dir"]))
        curves = [np.load(os.path.join(r["run_dir"], name)) for name in
                  ("expert_curve.npy", "gail_true_reward_curve.npy")]
        pairs = np.load(os.path.join(r["run_dir"], "expert_data.npz"))
        n_pairs = [pairs["states"].shape, pairs["actions"].shape]
        row = golden.check_scalar(gate, root=d)
    seconds = time.time() - t0
    summary, launches = r["summary"], r["launches"]
    want = ["config.json", "eval_rewards.npz", "expert_curve.npy",
            "expert_data.npz", "gail_true_reward_curve.npy", "summary.json"]
    if files != want or r["expert_info"]["iterations"] != 4 \
            or r["gail_iterations"] != GAIL_SMOKE_ITERS:
        raise AssertionError(f"{tag}: files {files}, expert "
                             f"{r['expert_info']}, {r['gail_iterations']} "
                             f"GAIL iterations")
    if not (np.isfinite(list(summary.values())).all()
            and all(np.isfinite(c).all() and len(c) for c in curves)
            and n_pairs == [(args["n_expert_transitions"], 3),
                            (args["n_expert_transitions"], 1)]):
        raise AssertionError(f"{tag}: summary {summary}, curves {curves}, "
                             f"expert set {n_pairs}")
    if row["status"] not in ("pass", "FAIL") \
            or row["ours"] != summary[gate["key"]]:
        raise AssertionError(f"{tag}: check_scalar read {row}")
    if launches:
        raise AssertionError(f"{tag}: {launches} sum-tree launches")
    line = (f"[gail {tag}] scripts/torch_gail_e2e.py's four stages: "
            f"{r['expert_info']['episodes']} expert episodes in "
            f"{r['expert_info']['iterations']} iterations, "
            f"{args['n_expert_transitions']} expert pairs, "
            f"{r['gail_iterations']} GAIL iterations; expert eval "
            f"{summary['expert_eval_avg']:.2f}, GAIL eval "
            f"{summary['gail_eval_avg']:.2f} (check_scalar: "
            f"{row['status']}); stages "
            f"{ {k: round(v, 1) for k, v in r['seconds'].items()} } s; "
            f"sumtree launches {launches}, {seconds:.1f} s")
    return dict(launches=launches, seconds=seconds, line=line)


def walker_count(run, device: str = "cuda"):
    """``run()`` with the sum-tree kernel's (B1's) and the walker kernels'
    (K2's, K3's) counts set to 0 just before and read just after: (its
    result, B1's, K2's and K3's launches, seconds)."""
    from freerl_tpu_torch.ops import bipedal

    def counted():
        bipedal.step_launches = bipedal.reset_launches = 0
        out = run()
        return out, bipedal.step_launches, bipedal.reset_launches

    (out, k2, k3), launches, seconds = sumtree_count(counted, device)
    return out, launches, k2, k3, seconds


# how ``cem_bipedal_recipe`` cuts scripts/r5_cem_bipedal.py's draw: the
# first ES generation (10 episodes) and two more, the first of them opened
# by a tell / ask, a population evaluation and the elite mixed in
CEM_SMOKE_EPISODES = 12


def cem_bipedal_recipe(tag: str, device: str = "cuda") -> dict:
    """The draw of ``golden.CEM_BIPEDAL_RUNS`` on ``device``, cut in depth:
    ``scripts/torch_r5_cem_bipedal.train``, the function each draw of the
    script runs (the walker under ``FixedResetWrapper(seed=0)``, batch
    256, replay 1e6, one learner step per domain env step past 1,000 env
    steps), for ``CEM_SMOKE_EPISODES`` episodes of draw 0. The returns
    must be finite and in the walker's range, the learner must have taken
    one step per burst row, from the CUDA graph of both bursts it kept on
    the card, the walker must have stepped through its kernels (K2 once a
    vector step, K3 at every auto-reset step and rollout start) and no
    sum-tree kernel may launch (uniform replay). Returns B1's, K2's and
    K3's launches, the seconds and a line to log."""
    from freerl_tpu_torch.algos import CEMGD3PG
    from scripts import torch_r5_cem_bipedal as cem

    learns, graphs = [], set()

    class Counted(CEMGD3PG):
        def learn_burst(self, state, buffer, buffer_domain, idx, *args,
                        **kw):
            learns.append(len(idx[0]))
            state = super().learn_burst(state, buffer, buffer_domain, idx,
                                        *args, **kw)
            kept = self.__dict__.get("_burst_graph")
            graphs.update(kept.graphs if kept is not None else ())
            return state

    r, launches, k2, k3, seconds = walker_count(
        lambda: cem.train(0, device, algo_cls=Counted,
                          max_episodes=CEM_SMOKE_EPISODES), device)
    returns, info, state = r["returns"], r["info"], r["state"]
    if not (len(returns) == CEM_SMOKE_EPISODES
            and np.isfinite(returns).all() and returns.min() >= -400.0
            and returns.max() <= 400.0 and learns
            and state.step == sum(learns)):
        raise AssertionError(f"{tag}: returns {returns}, {state.step} "
                             f"learner steps for bursts {learns}, {info}")
    if device == "cuda" and not (graphs and k2 and k3 >= k2):
        raise AssertionError(f"{tag}: graphs {graphs}, K2 {k2} and K3 {k3} "
                             f"launches")
    if launches:
        raise AssertionError(f"{tag}: {launches} sum-tree launches")
    line = (f"[cem_bipedal {tag}] scripts/torch_r5_cem_bipedal.py's draw 0 "
            f"for {CEM_SMOKE_EPISODES} episodes: {info['env_steps']} env "
            f"steps, {state.step} learner steps in {len(learns)} bursts "
            f"(CUDA graphs of branches {sorted(graphs)}), returns "
            f"{returns.min():.1f} .. {returns.max():.1f}; K2 {k2} and K3 {k3} "
            f"launches, sumtree launches {launches}, {seconds:.1f} s")
    return dict(launches=launches, k2=k2, k3=k3, seconds=seconds, line=line)


# how ``ppo_bipedal_recipe`` cuts scripts/r5_singles.py's PPO walker run:
# its first seed for this many updates of 2,048 transitions
PPO_WALKER_SMOKE_ITERS = 3


def ppo_bipedal_recipe(tag: str, device: str = "cuda") -> dict:
    """scripts/r5_singles.py's PPO BipedalWalker run (``golden.R5_RUNS``'s
    tag: 8 envs, horizon 2048, ``--fixed_reset``) on ``device``, cut in
    depth: the env and the algo the port's CLI builds from the tag's argv
    at its first seed, trained by ``train_onpolicy`` for
    ``PPO_WALKER_SMOKE_ITERS`` updates. It must take that many updates and
    env steps, its returns must be finite and in the walker's range, K2
    must launch once a vector step and K3 at least as often, and no
    sum-tree kernel may launch. Returns B1's, K2's and K3's launches, the
    seconds and a line to log."""
    from freerl_tpu_torch import cli
    from freerl_tpu_torch.train import OnPolicyConfig, golden, train_onpolicy

    argv = golden.r5_argv(tag, golden.R5_RUNS[tag][3][0])
    args = cli.parser().parse_args(argv + ["--device", device])
    env, algo = cli.build(args)
    steps = PPO_WALKER_SMOKE_ITERS * args.horizon
    cfg = OnPolicyConfig(seed=args.seed, num_envs=args.num_envs,
                         max_episodes=10**9, horizon=args.horizon,
                         max_env_steps=steps, host_sync_every=1)
    (_, returns, info), launches, k2, k3, seconds = walker_count(
        lambda: train_onpolicy(env, algo, cfg), device)
    returns = np.asarray(returns)
    vector_steps = steps // args.num_envs
    if not (info["iterations"] == PPO_WALKER_SMOKE_ITERS
            and info["env_steps"] == steps and np.isfinite(returns).all()
            and (not len(returns) or (returns.min() >= -400.0
                                      and returns.max() <= 400.0))):
        raise AssertionError(f"{tag}: returns {returns}, {info}")
    if device == "cuda" and not (k2 == vector_steps and k3 >= k2):
        raise AssertionError(f"{tag}: K2 {k2} and K3 {k3} launches for "
                             f"{vector_steps} vector steps")
    if launches:
        raise AssertionError(f"{tag}: {launches} sum-tree launches")
    line = (f"[ppo_bipedal {tag}] {' '.join(argv)}: {info['iterations']} "
            f"updates, {info['env_steps']} env steps, {len(returns)} "
            f"episodes"
            + (f" (returns {returns.min():.1f} .. {returns.max():.1f})"
               if len(returns) else "")
            + f"; K2 {k2} and K3 {k3} launches for {vector_steps} vector "
            f"steps, sumtree launches {launches}, {seconds:.1f} s")
    return dict(launches=launches, k2=k2, k3=k3, seconds=seconds, line=line)


# each table of recipes, by the name of its launches, the ``golden``
# attribute holding its tags, and the recipe of it
RECIPE_TABLES = (("n5", "N5_RUNS", n5_recipe),
                 ("spread", "SPREAD_RUNS", spread_recipe),
                 ("envelope", "ENVELOPE_RUNS", envelope_recipe),
                 ("pixel", "PIXEL_RUNS", pixel_recipe),
                 ("gail", "GAIL_RUNS", gail_recipe),
                 ("cem_bipedal", "CEM_BIPEDAL_RUNS", cem_bipedal_recipe),
                 ("ppo_bipedal", "R5_WALKER", ppo_bipedal_recipe))


def recipe(tag: str, device: str = "cuda") -> dict:
    """The recipe of ``RECIPE_TABLES`` whose table holds ``tag``."""
    from freerl_tpu_torch.train import golden

    fn = next(fn for _, table, fn in RECIPE_TABLES
              if tag in getattr(golden, table))
    return fn(tag, device)


def phase_determinism() -> None:
    """The same seed twice on the card, for every config of
    ``determinism_runs``: the records and every tensor of the final algo
    state (nets, targets, optimizer state; the expert set for GAIL) must
    be bit-equal, and the run must have taken an optimizer step."""
    from freerl_tpu_torch.distributed.dp import state_tensors

    failed = []
    for name, run in determinism_runs().items():
        t0 = time.time()
        (s1, r1, _), (s2, r2, _) = run(), run()
        t1, t2 = state_tensors(s1), state_tensors(s2)
        steps = sum(adam_steps(o) for o in optimizers_of(s1))
        differ = [k for k, (a, b) in enumerate(zip(t1, t2))
                  if not torch.equal(a, b)]
        same = np.array_equal(r1, r2) and len(t1) == len(t2) and not differ
        verdict = "bit-equal" if same else "NOT bit-equal"
        log(f"[determinism] {name}: twice {verdict}: {len(r1)} records, "
            f"{steps} optimizer steps, "
            f"{len(t1)} state tensors ({sum(t.numel() for t in t1)} "
            f"elements), {time.time() - t0:.1f} s")
        if not same:
            failed.append(f"{name}: records equal {np.array_equal(r1, r2)}, "
                          f"state tensors {len(t1)} / {len(t2)}, differing "
                          f"{differ}")
        elif not steps:
            failed.append(f"{name}: no optimizer step")
    if failed:
        raise AssertionError("determinism: " + "; ".join(failed))


# ---------------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")

    def timed(name, fn, *args, **kwargs):
        t0 = time.time()
        out = fn(*args, **kwargs)
        log(f"[time] {name}: {time.time() - t0:.1f} s")
        return out

    timed("build", phase_build)
    kernel = timed("sumtree", phase_sumtree)
    walker = timed("bipedal kernel", phase_bipedal_kernel)
    timed("card-vs-cpu", phase_card_vs_cpu)
    timed("card-vs-cpu family", phase_card_vs_cpu_family)
    kernel["launches"] = timed("main PER tree", phase_main_path, "PER tree",
                               per=True)
    timed("main uniform", phase_main_path, "uniform", per=False)
    kernel["launches_rainbow"] = timed("main Rainbow", phase_main_path,
                                       "Rainbow", **RAINBOW)
    timed("family", phase_family)
    timed("card-vs-cpu continuous", phase_card_vs_cpu_continuous)
    continuous = {name: timed(f"continuous {name}", phase_continuous, name)
                  for name in ("DDPG", "TD3", "SAC")}
    kernel["launches_continuous"] = (
        sum(c["launches"] for c in continuous.values())
        + timed("discrete actor-critic", phase_discrete_actor_critic)
        + timed("her", phase_her))
    # the on-policy phases, single- and multi-agent, card-vs-CPU and
    # trained, run in the learning block (BLOCK_PHASES)
    timed("card-vs-cpu marl", phase_card_vs_cpu_marl)
    kernel["launches_marl"] = sum(
        timed(f"marl {label}", phase_marl, label)["launches"]
        for label in MARL_PATHS)
    timed("card-vs-cpu slice 6", phase_card_vs_cpu_slice6)
    kernel["launches_slice6"] = sum(
        timed(name, fn) for name, fn in (
            ("gail", phase_gail), ("cem", phase_cem),
            ("envelope", phase_envelope), ("pixel", phase_pixel)))
    cem_graph = timed("cem graph", phase_cem_graph)
    if kernel["launches_slice6"]:
        raise AssertionError(f"the slice-6 paths launched the sum-tree "
                             f"kernel {kernel['launches_slice6']} times")
    timed("card-vs-cpu slice 7", phase_card_vs_cpu_slice7)
    # 0 on the CLI, host and SMAC paths; 8 for the 8 traced main-path steps
    kernel["launches_slice7"] = sum(
        timed(name, fn) for name, fn in (
            ("cli", phase_cli), ("host", phase_host), ("smac", phase_smac),
            ("profiling", phase_profiling)))
    # once per learner step on each rank of the data-parallel main path
    kernel["launches_dp"] = timed("dp and card-vs-cpu slice 8", phase_dp)[
        "launches"]
    timed("card-vs-cpu slice 8 one-rank NCCL", phase_nccl_one_rank)
    timed("golden", phase_golden)
    block = timed("learning checks and recipes", phase_learning_block)
    kernel["launches_onpolicy"] = block["onpolicy"]
    kernel["launches_marl"] += block["marl"]
    for name, _, _ in RECIPE_TABLES:
        kernel[f"launches_{name}"] = block[name]
    # K2 and K3 on this slice's main path, the CEM-GD3PG walker draw, and
    # on the PPO walker run
    for rec, i in zip(walker, (0, 1)):
        rec["launches"] = block["walker"]["CEM_GD3PG_4_seed"][i]
        rec["launches_ppo_bipedal"] = block["walker"]["PPO_BipedalWalker"][i]
        if not (rec["launches"] and rec["launches_ppo_bipedal"]):
            raise AssertionError(f"{rec['name']} was not launched on the "
                                 f"walker paths: {block['walker']}")
    walker[0]["cem_graph"] = cem_graph
    kernel["launches_bench"] = timed("bench", phase_bench)
    kernel["launches_per_bench"] = timed("per bench", phase_per_bench)
    kernel["launches_northstar"] = timed("northstar", phase_northstar)
    timed("golden vs jax", phase_golden_vs_jax)
    timed("fixed-reset starts", phase_fixed_reset_starts)
    timed("determinism", phase_determinism)
    left = stop_children()
    if left:
        raise AssertionError(f"processes still running after the phases, "
                             f"killed: {left}")
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s")

    print(json.dumps({"kernels": [kernel, *walker]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:    # a failed phase must not leave its processes behind either
        stop_children()
    sys.exit(code)
