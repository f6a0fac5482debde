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
9. a learning check: DQN on CartPole-v1, 8 envs, 4 updates per step,
   250 episodes, seed 0; the mean return of the last 30 episodes must
   clear ``CARTPOLE_THRESHOLD``;
10. print one JSON line describing each kernel, the card line, and the
    result line.

It needs no network and builds everything from the checkout.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12     # HBM3, NVIDIA H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12     # f32 outside the tensor cores, same source

MAIN_CAP_POW, MAIN_BATCH = 20, 256


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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
    """A tensor, or a dataclass / list / tuple of tensors, on ``dev``."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, dev) for v in x)
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
def drive(env_name: str, dqn_cfg, loop_cfg, dis_to_con: bool = False):
    """train_offpolicy on the card through the user's entry points, with
    the sum-tree kernel's count set to 0 just before and read just after.
    Checks finite losses and a consistent episode record; returns what the
    phases check and print."""
    from freerl_tpu_torch.algos import DQN
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.ops import sumtree
    from freerl_tpu_torch.train import train_offpolicy

    class ProbeDQN(DQN):
        """DQN that keeps each learner step's loss, its CUDA events and
        the buffer, for the checks after the run (no device sync)."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.losses, self.events, self.buffer = [], [], None

        def learn_step(self, state, buffer, generator, num_envs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, buffer, metrics = super().learn_step(
                state, buffer, generator, num_envs)
            end.record()
            self.events.append((start, end))
            self.losses.append(metrics["loss"])
            self.buffer = buffer
            return state, buffer, metrics

    env = make(env_name, dis_to_con=dis_to_con, device="cuda")
    algo = ProbeDQN(env.dim_info, dqn_cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sumtree.launches = 0
    _, returns, info = train_offpolicy(env, algo, loop_cfg)
    launches = sumtree.launches
    torch.cuda.synchronize()
    label = f"{env.name} {dqn_cfg}"
    if len(algo.losses) != info["updates"]:
        raise AssertionError(f"{label}: {len(algo.losses)} losses for "
                             f"{info['updates']} learner steps")
    if algo.losses and not bool(torch.isfinite(torch.stack(algo.losses)).all()):
        raise AssertionError(f"{label}: non-finite loss")
    if len(returns) != min(info["episodes"], loop_cfg.max_episodes):
        raise AssertionError(f"{label}: episode record {len(returns)} for "
                             f"{info}")
    if not np.isfinite(returns).all():
        raise AssertionError(f"{label}: non-finite episode return")
    return dict(
        env=env, algo=algo, returns=returns, info=info, launches=launches,
        peak_mib=torch.cuda.max_memory_allocated() / 2**20,
        learn_ms=float(np.mean([s.elapsed_time(e) for s, e in algo.events]))
        if algo.events else float("nan"))


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


# the port on the CPU, this configuration, seeds 0-19, read 40.1-431.9 as
# the mean of the last 30 of 250 episodes, three seeds under 60
# (scripts/cartpole_seeds.py --device cpu); a uniform-random policy
# averages about 22. The JAX package's recipe expects more than 60.
CARTPOLE_THRESHOLD = 30.0


def phase_learning():
    from freerl_tpu_torch.algos import DQNConfig
    from freerl_tpu_torch.train import OffPolicyConfig

    cfg = OffPolicyConfig(seed=0, num_envs=8, max_episodes=250,
                          start_steps=500, updates_per_burst=4,
                          chunk_size=128)
    r = drive("CartPole-v1", DQNConfig(buffer_size=20_000, batch_size=64),
              cfg)
    returns = r["returns"]
    first, last = float(returns[:10].mean()), float(returns[-30:].mean())
    log(f"[learning CartPole-v1] {len(returns)} episodes, "
        f"{r['info']['env_steps']} env steps in {r['info']['elapsed_s']:.1f} "
        f"s: first 10 episodes {first:.1f}, last 30 {last:.1f} (threshold "
        f"{CARTPOLE_THRESHOLD})")
    if len(returns) != 250 or not last > CARTPOLE_THRESHOLD:
        raise AssertionError(f"CartPole did not learn: last 30 mean {last}")


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

    phase_build()
    kernel = phase_sumtree()
    phase_card_vs_cpu()
    phase_card_vs_cpu_family()
    kernel["launches"] = phase_main_path("PER tree", per=True)
    phase_main_path("uniform", per=False)
    kernel["launches_rainbow"] = phase_main_path("Rainbow", **RAINBOW)
    phase_family()
    phase_learning()
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s")

    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
