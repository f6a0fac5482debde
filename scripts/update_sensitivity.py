"""How far one full update of the multi-agent on-policy family moves under
float32 rounding alone, and where in the update it starts to move.

    python3 scripts/update_sensitivity.py [--device cuda|cpu] [--t 16]
        [--seeds 3,5,9] [--own-rollouts] [--variants "MAPPO stacked,..."]

For each variant of ``chip_smoke.MARL_ONPOLICY_VARIANTS`` (full width,
the random (T, 64) rollout ``chip_smoke.py`` draws for it, the update's
K_epochs x four 256-minibatches per agent), runs the update from
identical params, rollout and draws:

- on the CPU, the reference;
- on the CPU in float64 (the update's exact answer, to float32's
  resolution);
- on the CPU from the initial params perturbed by 1e-7 relative (a few
  float32 ulps), once for each perturbation seed;
- on the card (the default, ``--device cuda``), free-running, and from
  the same perturbed params. ``--device cpu`` leaves the card runs out.

and prints one JSON line per variant: for each run, the largest absolute
difference of any param from the reference after the update
(``max_abs``), the number of elements past 1e-5 (``past_1e-5``), and
the first Adam step at which the params differ from the reference's by
more than ``chip_smoke.py``'s tolerance (over the steps so far, more
than one element in 10,000 past 1e-5, or any past the lr;
``first_step_past``, null if none) out of ``steps``; and
(``vs_f64``) the same against the float64 run.
``chip_smoke.py`` holds the card to the CPU free-running for each
variant's first ``FREE_STEPS`` Adam steps and step by step after that,
because these free-running differences grow with the update's length.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from freerl_tpu_torch.algos import Rollout  # noqa: E402


def cast(x, dev: str, dtype: torch.dtype):
    """``cs.to_device`` with every floating tensor cast to ``dtype``."""
    x = cs.to_device(x, dev)
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: cast(v, dev, dtype) for k, v in x.items()}
    return type(x)(**{k: cast(v, dev, dtype) for k, v in vars(x).items()})


@contextlib.contextmanager
def default_dtype(dtype: torch.dtype):
    """Tensors made without a dtype (params, the update's temporaries) in
    ``dtype``."""
    default = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(default)


def update(label: str, dev: str, t: int, init, perturb: float = 0.0,
           seed: int = 9, dtype: torch.dtype = torch.float32,
           own_rollout: bool = False):
    """Each Adam step's params, and every param after the update (all on
    the CPU), of one update of the variant on ``dev`` in ``dtype``, from
    the params of ``init`` (a CPU state) perturbed by ``perturb`` relative
    (noise from ``seed``); ``own_rollout``: the variant's rollout from a
    RandomState(7) of its own instead of the phase's."""
    env_name, algo_name, kw = cs.MARL_ONPOLICY_VARIANTS[label]
    with default_dtype(dtype):
        env = cs.marl_env(env_name, dev)
        algo = cs.marl_onpolicy_algo(algo_name, env, dev, **kw)
        state = algo.init(torch.Generator(device=dev).manual_seed(0))
    for net, ref in zip(cs.state_nets(state), cs.state_nets(init)):
        net.load_state_dict(ref.state_dict())
    noise = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for net in cs.state_nets(state):
            for p in net.parameters():
                p.mul_(1.0 + perturb * torch.randn(
                    p.shape, generator=noise).to(dev, dtype))
    if own_rollout:
        env_cpu = cs.marl_env(env_name, "cpu")
        roll_np = cs.marl_onpolicy_rollout(
            env_cpu, t, 64, np.random.RandomState(7),
            mask_dim=kw.get("mask_dim"),
            per_dim_logp=algo_name == "MAT" and env_cpu.dim_info.is_continue)
    else:
        roll_np = cs.marl_onpolicy_rollouts(t, 64)[label]
    roll = Rollout(**{k: torch.as_tensor(v) for k, v in roll_np.items()})
    # the draws, and a recurrent algo's extras, from the CPU
    cpu = cs.marl_onpolicy_algo(algo_name, cs.marl_env(env_name, "cpu"),
                                "cpu", **kw)
    kwargs = {}
    if hasattr(algo, "init_policy_carry"):
        # the extras of a rollout from a zero carry
        carry, dp, steps = cpu.init_policy_carry(64), torch.zeros(
            64, dtype=torch.bool), []
        gen = torch.Generator().manual_seed(1)
        for s in range(t):
            *_, carry, ex = cpu.sample_action(
                init, roll.obs[s], cpu.draw_action(64, gen), carry, dp)
            steps.append(ex)
            dp = roll.adv_done[s]
        kwargs["extras"] = cast(
            {k: torch.stack([e[k] for e in steps]) for k in steps[0]},
            dev, dtype)
    draws = cpu.draw_update(roll, torch.Generator().manual_seed(2))
    with cs.AdamSteps() as rec, default_dtype(dtype):
        algo.update(state, cast(roll, dev, dtype), cs.to_device(draws, dev),
                    episodes=torch.tensor(40, device=dev), **kwargs)
    return ([([p.cpu() for p in params], lr)
             for params, _, lr in rec.steps], flat(state))


def flat(state) -> torch.Tensor:
    return torch.cat([p.detach().flatten().double().cpu()
                      for net in cs.state_nets(state)
                      for _, p in sorted(net.state_dict().items())])


def compare(run, ref) -> dict:
    """The final and the step-by-step distance of ``run`` from ``ref``
    (each an ``update`` result)."""
    first, past, n = None, 0, 0
    for k, ((got, _), (want, lr)) in enumerate(zip(run[0], ref[0])):
        d = torch.cat([(g.double() - w.double()).abs().flatten()
                       for g, w in zip(got, want)])
        past, n = past + int((d > 1e-5).sum()), n + d.numel()
        if past > n // 10_000 or bool((d > lr).any()):
            first = k
            break
    d = (run[1] - ref[1]).abs()
    return {"max_abs": float(d.max()), "past_1e-5": int((d > 1e-5).sum()),
            "first_step_past": first}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--t", type=int, default=16)
    ap.add_argument("--seeds", default="3,5,9")
    ap.add_argument("--own-rollouts", action="store_true",
                    help="each variant's rollout from a RandomState(7) of "
                         "its own, not the sequence chip_smoke.py draws")
    ap.add_argument("--variants", default=",".join(
        cs.MARL_ONPOLICY_VARIANTS))
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("update_sensitivity: no CUDA card (--device cpu runs "
                  "the CPU only)", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(",")]
    for label in args.variants.split(","):
        env_name, algo_name, kw = cs.MARL_ONPOLICY_VARIANTS[label]
        init = cs.marl_onpolicy_algo(algo_name, cs.marl_env(env_name, "cpu"),
                                     "cpu", **kw).init(
                                         torch.Generator().manual_seed(0))
        own = args.own_rollouts
        ref = update(label, "cpu", args.t, init, own_rollout=own)
        exact = update(label, "cpu", args.t, init, dtype=torch.float64,
                       own_rollout=own)
        out = {"variant": label, "t": args.t, "steps": len(ref[0]),
               "elements": ref[1].numel(), "cpu_f64": compare(exact, ref)}
        runs = [(f"cpu_perturbed_{s}", "cpu", 1e-7, s) for s in seeds]
        if args.device == "cuda":
            runs += [("card", "cuda", 0.0, 0)] + [
                (f"card_perturbed_{s}", "cuda", 1e-7, s) for s in seeds]
        for name, dev, eps, seed in runs:
            run = update(label, dev, args.t, init, eps, seed, own_rollout=own)
            out[name] = compare(run, ref)
            out[name]["vs_f64"] = compare(run, exact)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
