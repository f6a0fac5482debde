"""DQN's conv-trunk gradients on the card against the CPU, seed by seed:
the numbers behind ``chip_smoke.py``'s ``dqn_<arch>_grads`` check.

    python3 scripts/torch_conv_check.py [--arch nature|small] [--seeds 20]
        [--detail SEED ...]

For each seed, a batch of 64 as ``chip_smoke.phase_card_vs_cpu_slice6``
draws it (uniform pixels, ``torch.manual_seed(seed)``; actions, rewards
and dones from ``np.random.RandomState(seed)``) goes through one DQN update
(``obs_shape`` (84, 84, 4) for the nature trunk, (48, 48, 2) for the small
one; batch 64) from the same init on the CPU twice and on the card four
times: twice with cuDNN's default algorithms and twice with
``torch.backends.cudnn.deterministic = True``. TF32 is off. One JSON line
per seed says whether each device repeated itself bit for bit, the
card-against-CPU gradient error as the check computes it (relative to the
CPU's magnitude where above 1) and the elements past 1e-5, and the ReLU
units whose pre-activation has another sign on the card than on the CPU
from the same layer input (the trunk's layers, then its dense layer).
``--detail`` breaks the given seeds down parameter by parameter against
a float64 reference on the CPU.
"""
from __future__ import annotations

import argparse
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


def check(seed: int, arch: str) -> dict:
    import chip_smoke

    b, make_twins = setup(seed, arch)

    def run(dev: str, deterministic: bool = False) -> torch.Tensor:
        torch.backends.cudnn.deterministic = deterministic
        try:
            algo, st = make_twins()[dev]
            return grads_of(algo, st, chip_smoke.to_device(b, dev))
        finally:
            torch.backends.cudnn.deterministic = False

    cpu = [run("cpu") for _ in range(2)]
    card = [run("cuda") for _ in range(2)]
    card_det = [run("cuda", True) for _ in range(2)]

    def err(g):
        e = (cpu[0].double() - g.double()).abs()
        e = e / cpu[0].double().abs().clamp(min=1.0)
        return [float(e.max()), int((e > 1e-5).sum())]

    pair = make_twins()
    return {
        "seed": seed, "arch": arch,
        "cpu_repeats": bool(torch.equal(*cpu)),
        "card_repeats": bool(torch.equal(*card)),
        "card_deterministic_repeats": bool(torch.equal(*card_det)),
        "err_past_1e-5": [err(g) for g in card],
        "err_past_1e-5_deterministic": [err(g) for g in card_det],
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="nature", choices=sorted(ARCHS))
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--detail", type=int, nargs="*", default=[],
                    help="seeds to break down parameter by parameter")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_conv_check: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in range(args.seeds):
        print(json.dumps(check(seed, args.arch)), flush=True)
    for seed in args.detail:
        print(json.dumps(detail(seed, args.arch)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
