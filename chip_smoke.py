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
   (LunarLander steps, DQN updates, the PER buffer);
5. the main path: train_offpolicy on LunarLander-v2 with
   DQNConfig(per=True, per_sampler="tree") at full width (8-128-4 net,
   buffer 1e6 -> 2^20, batch 256), 1024 envs; the sum-tree kernel must be
   launched once per learner step;
6. the same loop with uniform replay (per=False);
7. print one JSON line describing each kernel, the card line, and the
   result line.

It needs no network and builds everything from the checkout.
"""
from __future__ import annotations

import ctypes
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
def phase_main_path(per: bool):
    from freerl_tpu_torch.algos import DQN, DQNConfig
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.ops import sumtree
    from freerl_tpu_torch.train import OffPolicyConfig, train_offpolicy

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

    label = "PER tree" if per else "uniform"
    env = make("LunarLander-v2", device="cuda")
    algo = ProbeDQN(env.dim_info, DQNConfig(per=per, per_sampler="tree",
                                            buffer_size=1_000_000,
                                            batch_size=256, hidden=(128,)),
                    device="cuda")
    num_envs, chunk = 1024, 64
    cfg = OffPolicyConfig(seed=0, num_envs=num_envs, start_steps=500,
                          updates_per_burst=1, chunk_size=chunk,
                          max_env_steps=num_envs * chunk * 4,
                          max_episodes=10**9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sumtree.launches = 0
    _, returns, info = train_offpolicy(env, algo, cfg)
    launches = sumtree.launches
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    losses = torch.stack(algo.losses)
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{label}: non-finite loss")
    if info["updates"] < 200 or len(algo.losses) != info["updates"]:
        raise AssertionError(f"{label}: {info['updates']} learner steps")
    if info["episodes"] <= 0 or len(returns) != info["episodes"]:
        raise AssertionError(f"{label}: episode record {info}")
    if not np.isfinite(returns).all():
        raise AssertionError(f"{label}: non-finite episode return")
    if per:
        if launches != info["updates"]:
            raise AssertionError(
                f"sumtree kernel launched {launches} times for "
                f"{info['updates']} learner steps")
        buf = algo.buffer
        root = float(buf.tree[1])
        leaves = float(buf.tree[buf.capacity:].double().sum())
        if abs(root - leaves) > 1e-4 * abs(leaves):
            raise AssertionError(f"PER root {root} != sum of leaves {leaves}")
    elif launches != 0:
        raise AssertionError("uniform replay launched the sum-tree kernel")
    learn_ms = float(np.mean([s.elapsed_time(e) for s, e in algo.events]))
    log(f"[main {label}] {info['env_steps']} env steps, {info['updates']} "
        f"learner steps, {info['episodes']} episodes (mean return "
        f"{returns.mean():.1f}) in {info['elapsed_s']:.2f} s: "
        f"{info['env_steps_per_s']:.0f} env-steps/s, learner step "
        f"{learn_ms:.3f} ms, peak memory {peak / 2**20:.1f} MiB, "
        f"sumtree launches {launches}")
    return launches


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
    kernel["launches"] = phase_main_path(per=True)
    phase_main_path(per=False)
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
