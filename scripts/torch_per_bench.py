"""PER sampling micro-bench of the PyTorch port: the sum-tree sampler (the
CUDA kernel ``csrc/sumtree_descend.cu``, B1) against the cumsum sampler
(counterpart: ``scripts/per_bench.py``).

    python3 scripts/torch_per_bench.py [--capacity 1048576] [--batch 256]
        [--iters 200] [--device cuda|cpu] [--out build/torch_per_bench.json]

One PER learner cycle per iteration: add a 256-row batch, sample 256 with IS
weights, write the priorities ``w + 0.5``, at a capacity of 2^20. Cycles
run in chunks of 20 with no host sync inside; one chunk warms up, then
``--iters`` cycles are timed between ``torch.cuda.synchronize()`` calls.

On the card the tree sampler always descends through B1, so its ``tree``
row is the counterpart of the JAX bench's ``tree_pallas`` row; the JAX
bench's XLA ``tree`` row has none here. The script reads the kernel's
launch count around each variant: on the card ``tree`` must launch B1 once
per sample and ``cumsum`` never (on the CPU both use the plain twin and
launch nothing). Prints one JSON line and writes it to ``--out``, under
the git-ignored ``build/`` by default.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

CYCLES_PER_CHUNK = 20


def run(capacity: int = 1 << 20, batch: int = 256, iters: int = 200,
        device="cuda") -> dict:
    """Time both samplers; returns the result dict (cycle µs per variant,
    samples and B1 launches per variant, the device)."""
    from freerl_tpu_torch.buffers.per import PERBuffer
    from freerl_tpu_torch.core.types import Transition
    from freerl_tpu_torch.ops import sumtree

    device = torch.device(device)

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    example = Transition(
        obs=zeros((8,)), action=zeros((), torch.int32), reward=zeros(()),
        next_obs=zeros((8,)), done=zeros((), torch.bool),
        episode_done=zeros((), torch.bool))
    rows = Transition(
        obs=zeros((batch, 8)), action=zeros((batch,), torch.int32),
        reward=zeros((batch,)), next_obs=zeros((batch, 8)),
        done=zeros((batch,), torch.bool),
        episode_done=zeros((batch,), torch.bool))
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    n_chunks = max(iters // CYCLES_PER_CHUNK, 1)

    cycle_us, samples, launches = {}, {}, {}
    for name in ("tree", "cumsum"):
        gen = torch.Generator(device=device).manual_seed(0)
        buf = PERBuffer.create(capacity, example, sampler=name)
        buf = buf.add(rows)
        n_samples = 0

        def chunk(buf):
            nonlocal n_samples
            for _ in range(CYCLES_PER_CHUNK):
                buf = buf.add(rows)
                _, idx, w = buf.sample(buf.draw(gen, batch))
                buf = buf.update_priorities(idx, w + 0.5)
                n_samples += 1
            return buf

        before = sumtree.launches
        buf = chunk(buf)
        sync()
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            buf = chunk(buf)
        sync()
        us = (time.perf_counter() - t0) / (n_chunks * CYCLES_PER_CHUNK) * 1e6
        cycle_us[name] = us
        samples[name] = n_samples
        launches[name] = sumtree.launches - before
        print(f"{name:12s} {us:8.1f} us per add+sample+update cycle",
              flush=True)

    want = ({"tree": samples["tree"], "cumsum": 0} if device.type == "cuda"
            else {"tree": 0, "cumsum": 0})
    if launches != want:
        raise AssertionError(f"torch_per_bench: B1 launches {launches}, "
                             f"expected {want}")
    return {"device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "capacity": buf.capacity, "batch": batch,
            "cycle_us": cycle_us, "samples": samples,
            "sumtree_launches": launches}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--capacity", type=int, default=1 << 20)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=os.path.join("build",
                                                  "torch_per_bench.json"))
    args = ap.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("torch_per_bench: no CUDA card; pass --device cpu to run the "
              "plain twins on the CPU", file=sys.stderr)
        return 1
    out = run(args.capacity, args.batch, args.iters, args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
