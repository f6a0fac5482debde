"""DQN's conv-trunk gradients on the card against the CPU, seed by seed:
the numbers behind ``chip_smoke.py``'s ``dqn_<arch>_grads`` check; and,
with ``--time``, what the trunk's deterministic convolutions cost.

    python3 scripts/torch_conv_check.py [--arch nature|small] [--seeds 20]
        [--detail SEED ...]
    python3 scripts/torch_conv_check.py --time

For each seed, a batch of 64 as ``chip_smoke.phase_card_vs_cpu_slice6``
draws it (uniform pixels, ``torch.manual_seed(seed)``; actions, rewards
and dones from ``np.random.RandomState(seed)``) goes through one DQN update
(``obs_shape`` (84, 84, 4) for the nature trunk, (48, 48, 2) for the small
one; batch 64) from the same init on the CPU twice and on the card four
times: twice with the trunk as it runs (cuDNN's deterministic algorithms,
``nets/cnn.py:conv2d``) and twice with its convolutions on plain
``F.conv2d`` under cuDNN's default algorithms. TF32 is off. One JSON line
per seed says whether each device repeated itself bit for bit, the
card-against-CPU gradient error as the check computes it (relative to the
CPU's magnitude where above 1) and the elements past 1e-5, and the ReLU
units whose pre-activation has another sign on the card than on the CPU
from the same layer input (the trunk's layers, then its dense layer).
``--detail`` breaks the given seeds down parameter by parameter against
a float64 reference on the CPU.

``--time`` times, on the card with TF32 off, with the trunk as it runs and
with its convolutions on cuDNN's default algorithms, in turns
(deterministic, default, default, deterministic, in each of two rounds):
the pixel DQN learner step (``chip_smoke.phase_pixel``'s config: the
small trunk of 128 features, replay 100k holding 10,240 random rows,
batch 64; 50 steps),
one DQN update through the nature trunk at (84, 84, 4), batch 64 (50
updates), and one conv-PPO update (PPO's defaults after a small trunk of
256 features, 256 envs, T 16: 640 minibatch steps), each in ms from CUDA
events; then, per kind, one profiled reading: the device's kernel time
per call and the kernels that take the most, which tell the algorithms'
device cost from the host's. One JSON line per workload, then one with
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

ARCHS = {"nature": ((84, 84, 4), 512), "small": ((48, 48, 2), 128)}


def grads_of(algo, state, batch) -> torch.Tensor:
    algo.update(state, batch)
    return torch.cat([p.grad.flatten().cpu()
                      for p in state.net.parameters()])


def sign_flips(net_cpu, net_card, obs: torch.Tensor) -> list:
    """Per ReLU layer of the trunk (and the first hidden layer), the units
    whose pre-activation sign differs between the devices, each device
    given the CPU's input to that layer."""
    from freerl_tpu_torch.nets.cnn import ConvTrunk

    trunks = [next(m for m in n.modules() if isinstance(m, ConvTrunk))
              for n in (net_cpu, net_card)]
    t_cpu, t_card = trunks
    x = obs.reshape((-1,) + t_cpu.obs_shape).permute(0, 3, 1, 2)
    flips = []
    with torch.no_grad():
        for i, s in enumerate(t_cpu.strides):
            pre = F.conv2d(x, t_cpu.convs[i], t_cpu.biases[i], stride=s)
            pre_card = F.conv2d(x.cuda(), t_card.convs[i], t_card.biases[i],
                                stride=s).cpu()
            flips.append(int(((pre > 0) != (pre_card > 0)).sum()))
            x = F.relu(pre)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        pre, pre_card = t_cpu.dense(x), t_card.dense(x.cuda()).cpu()
        flips.append(int(((pre > 0) != (pre_card > 0)).sum()))
    return flips


def setup(seed: int, arch: str):
    """The seed's batch (on the CPU) and a function that builds the DQN
    twins (``chip_smoke.twins``: the card's nets loaded with the CPU's
    init)."""
    import chip_smoke
    from freerl_tpu_torch.algos import DQN, DQNConfig
    from freerl_tpu_torch.core.types import DimInfo, Transition

    shape, feats = ARCHS[arch]
    obs_dim = int(np.prod(shape))
    di = DimInfo(obs_dim=obs_dim, action_dim=2)
    cfg = DQNConfig(obs_shape=shape, conv_arch=arch, cnn_features=feats,
                    batch_size=64)
    torch.manual_seed(seed)
    rng = np.random.RandomState(seed)
    done = rng.rand(64) < 0.1
    b = Transition(obs=torch.rand(64, obs_dim),
                   action=torch.as_tensor(rng.randint(0, 2, 64)),
                   reward=torch.randn(64), next_obs=torch.rand(64, obs_dim),
                   done=torch.as_tensor(done),
                   episode_done=torch.as_tensor(done))
    return b, lambda: chip_smoke.twins(lambda d: DQN(di, cfg, device=d),
                                       ("net", "target_net"))


@contextlib.contextmanager
def conv_algorithms(kind: str):
    """``"deterministic"``: the trunk as it runs; ``"default"``: the
    trunk's convolutions on plain ``F.conv2d``, so on the algorithms
    cuDNN picks under the process's settings."""
    from freerl_tpu_torch.nets import cnn

    saved = cnn.conv2d
    if kind == "default":
        cnn.conv2d = F.conv2d     # (x, weight, bias, stride), as conv2d
    try:
        yield
    finally:
        cnn.conv2d = saved


def check(seed: int, arch: str) -> dict:
    import chip_smoke

    b, make_twins = setup(seed, arch)

    def run(dev: str, kind: str = "deterministic") -> torch.Tensor:
        with conv_algorithms(kind):
            algo, st = make_twins()[dev]
            return grads_of(algo, st, chip_smoke.to_device(b, dev))

    cpu = [run("cpu") for _ in range(2)]
    card = [run("cuda") for _ in range(2)]
    card_default = [run("cuda", "default") for _ in range(2)]

    def err(g):
        e = (cpu[0].double() - g.double()).abs()
        e = e / cpu[0].double().abs().clamp(min=1.0)
        return [float(e.max()), int((e > 1e-5).sum())]

    pair = make_twins()
    return {
        "seed": seed, "arch": arch,
        "cpu_repeats": bool(torch.equal(*cpu)),
        "card_repeats": bool(torch.equal(*card)),
        "card_default_algorithms_repeats": bool(torch.equal(*card_default)),
        "err_past_1e-5": [err(g) for g in card],
        "err_past_1e-5_default_algorithms": [err(g) for g in card_default],
        "relu_sign_flips": sign_flips(pair["cpu"][1].net,
                                      pair["cuda"][1].net, b.obs),
    }


def detail(seed: int, arch: str) -> dict:
    """One seed parameter by parameter: each device's float32 gradient
    against the CPU's float64 one (the plain DQN loss, mean of (Q(s, a) -
    r - 0.99 (1 - d) max_a' Q'(s', a'))^2, in float64 from the same init),
    and the hidden layer's ReLU sign flips from the CPU's trunk output."""
    import copy

    import chip_smoke

    b, make_twins = setup(seed, arch)
    pair = make_twins()
    net64 = copy.deepcopy(pair["cpu"][1].net).double()
    tgt64 = copy.deepcopy(pair["cpu"][1].target_net).double()
    with torch.no_grad():
        x = pair["cpu"][1].net.conv(b.obs)
        hid = pair["cpu"][1].net.hidden[0]
        hid_card = pair["cuda"][1].net.hidden[0]
        flips = int(((hid(x) > 0) != (hid_card(x.cuda()).cpu() > 0)).sum())
        tq = tgt64(b.next_obs.double())
        target = (b.reward.double()
                  + 0.99 * (1 - b.done.double()) * tq.max(1).values)
    q = net64(b.obs.double()).gather(1, b.action.long()[:, None])[:, 0]
    torch.mean((q - target) ** 2).backward()
    g = {dev: grads_of(algo, st, chip_smoke.to_device(b, dev))
         for dev, (algo, st) in pair.items()}
    g64 = torch.cat([p.grad.flatten() for p in net64.parameters()])
    rows, off = {}, 0
    for name, p in net64.named_parameters():
        sl = slice(off, off + p.numel())
        off += p.numel()
        ref = g64[sl].abs().clamp(min=1.0)
        rows[name] = {
            dev: [float(((g[dev][sl].double() - g64[sl]).abs() / ref).max()),
                  int((((g[dev][sl].double() - g64[sl]).abs() / ref)
                       > 1e-5).sum())] for dev in g}
    gap = (g["cpu"].double() - g["cuda"].double()).abs()
    return {"seed": seed, "arch": arch,
            "card_vs_cpu": float((gap / g["cpu"].double().abs().clamp(
                min=1.0)).max()),
            "target_ties": int((tq[:, 0] - tq[:, 1]).abs().lt(1e-6).sum()),
            "hidden_relu_sign_flips": flips,
            "vs_float64_max_and_past_1e-5": rows}


def events_ms(step, calls: int) -> float:
    """Mean ms of ``step()`` over ``calls`` calls, from CUDA events around
    the calls."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def kernel_ms(step, calls: int, top: int = 4) -> dict:
    """Device kernel time of ``step()`` per call under torch.profiler: the
    sum over every kernel, and the ``top`` kernels (by name) that take the
    most."""
    from chip_smoke import device_kernels

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
    by_name = {}
    for e in device_kernels(prof):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    names = sorted(by_name, key=by_name.get, reverse=True)[:top]
    return {"kernels_ms": sum(by_name.values()) / calls,
            "top": [[n[:90], by_name[n] / calls] for n in names]}


def pixel_dqn_learner_step():
    """``phase_pixel``'s pixel DQN at a learner step: (step, calls)."""
    import chip_smoke
    from freerl_tpu_torch.algos import DQN, DQNConfig
    from freerl_tpu_torch.envs import make
    from freerl_tpu_torch.train.loop import example_transition

    env, num_envs = make("PixelCartPole-v1", device="cuda"), 512
    algo = DQN(env.dim_info, DQNConfig(
        buffer_size=100_000, batch_size=64, obs_shape=env.obs_shape,
        conv_arch="small", cnn_features=128), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    state = algo.init(g)
    example = example_transition(env, algo)
    buffer = algo.make_buffer(example, num_envs)
    for _ in range(20):
        buffer.add(chip_smoke.random_rows(example, num_envs,
                                          env.dim_info.action_dim, g))

    def step():
        algo.learn_step(state, buffer, g, num_envs)
    return step, 50


def nature_dqn_update():
    """One DQN update through the nature trunk at (84, 84, 4), batch 64,
    on seed 0's batch: (step, calls)."""
    b, make_twins = setup(0, "nature")
    import chip_smoke

    algo, state = make_twins()["cuda"]
    batch = chip_smoke.to_device(b, "cuda")
    return lambda: algo.update(state, batch), 50


def conv_ppo_update():
    """``phase_pixel``'s conv PPO (256 envs, T 16) at one update on a
    random rollout: (step, calls)."""
    import chip_smoke
    from freerl_tpu_torch.algos import PPO, PPOConfig
    from freerl_tpu_torch.envs import make

    env, n, t = make("PixelCartPole-v1", device="cuda"), 256, 16
    algo = PPO(env.dim_info, PPOConfig(horizon=n * t, num_envs=n,
                                       obs_shape=env.obs_shape),
               device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    state = algo.init(g)
    rollout = chip_smoke.random_rollout(env, algo, t, n, g)
    perms = algo.draw_update(rollout, g)
    return lambda: algo.update(state, rollout, perms), 1


ROUNDS = 2  # --time: rounds of four readings per workload
TIMED = {"pixel DQN learner step (small trunk, batch 64)":
         pixel_dqn_learner_step,
         "DQN update (nature trunk, (84, 84, 4), batch 64)":
         nature_dqn_update,
         "conv-PPO update (256 envs, T 16)": conv_ppo_update}


def time_trunks() -> None:
    """``--time``: each workload's ms with the trunk's deterministic
    convolutions and with cuDNN's default algorithms, in turns."""
    import chip_smoke

    for name, build in TIMED.items():
        step, calls = build()
        ms = {"deterministic": [], "default": []}
        for kind in ms:                 # warm-up: cuDNN's plans, allocator
            with conv_algorithms(kind):
                step()
        for _ in range(ROUNDS):
            for kind in ("deterministic", "default", "default",
                         "deterministic"):
                with conv_algorithms(kind):
                    ms[kind].append(events_ms(step, calls))
        med = {k: float(np.median(v)) for k, v in ms.items()}
        kernels = {}
        for kind in ms:
            with conv_algorithms(kind):
                kernels[kind] = kernel_ms(step, calls)
        print(json.dumps({
            "workload": name, "calls_per_reading": calls,
            "deterministic_ms": ms["deterministic"],
            "default_ms": ms["default"],
            "median_ratio": med["deterministic"] / med["default"],
            "profiled_deterministic": kernels["deterministic"],
            "profiled_default": kernels["default"]}), flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "name_power_limit": chip_smoke.card_line()}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="nature", choices=sorted(ARCHS))
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--detail", type=int, nargs="*", default=[],
                    help="seeds to break down parameter by parameter")
    ap.add_argument("--time", action="store_true",
                    help="time the trunk's deterministic convolutions "
                         "against cuDNN's default algorithms instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_conv_check: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.time:
        time_trunks()
        return 0
    for seed in range(args.seeds):
        print(json.dumps(check(seed, args.arch)), flush=True)
    for seed in args.detail:
        print(json.dumps(detail(seed, args.arch)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
