"""What the port's data-parallel parity tests share: launching the 2-rank
worker (``_torch_dp_worker.py``), the JAX package's ``shard_map`` over a
2-device slice of the conftest's CPU mesh, and the comparison of two port
learner states.

A :class:`Case` is one sharded update: the JAX algo (its config carrying
``axis_name="dp"``) and learner state, the port's algo and the same state,
and each device's inputs in both forms. The JAX side runs in the test
process while the ranks run the port side; JAX is imported inside the
functions, so the ranks never load it.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from typing import Callable

import numpy as np
import torch

from freerl_tpu_torch.train.runio import load_checkpoint, save_checkpoint

WORKER = os.path.join(os.path.dirname(__file__), "_torch_dp_worker.py")
ATOL = 1e-5


def start(d, job: str, world: int = 2) -> list:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(d), job],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(WORKER))) for r in range(world)]


def finish(procs: list, timeout: float = 240.0) -> None:
    """Wait for every rank (each within ``timeout``); a rank that failed
    or hung fails the test, and none is left running."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"


def launch(d, job: str, world: int = 2, timeout: float = 240.0) -> None:
    finish(start(d, job, world), timeout)


@dataclasses.dataclass
class Case:
    """One sharded update. ``jfn(jstate, inputs) -> jstate`` is the JAX
    side on one device's inputs; ``calls[d]`` the port methods rank d
    applies in turn, as ``(method, args, kwargs)``; ``to_port(jstate)`` a
    port state carrying a JAX state's nets."""

    algo: object
    state: object
    jstate: object
    jinputs: list
    calls: list
    jfn: Callable
    to_port: Callable


def sharded_jax(jfn, jstate, per_device: list) -> list:
    """``jfn`` inside a ``shard_map`` over 2 CPU devices: the state
    replicated, device d given ``per_device[d]``; every device's output
    state, in device order."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from freerl_tpu.distributed.dp import make_mesh, shard_map

    mesh = make_mesh(2)
    stacked = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x)
                                                  for x in xs]), *per_device)

    def body(s, x):
        out = jfn(s, jax.tree.map(lambda a: a[0], x))
        return jax.tree.map(lambda a: a[None], out)

    with mesh:
        out = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P("dp")),
                                out_specs=P("dp"), check_rep=False))(
            jstate, stacked)
    return [jax.tree.map(lambda a: a[d], out) for d in range(2)]


def run_cases(cases: dict, d) -> dict:
    """Every case on 2 CPU ranks (one launch) and in JAX's shard_map, side
    by side; returns ``{name: [(port state of rank d, port state carrying
    JAX device d's nets, JAX device d's state)] for d in 0, 1}``."""
    payload = {}
    for name, c in cases.items():
        path = os.path.join(d, f"state_{name}.pt")
        save_checkpoint(path, c.state)
        payload[name] = dict(algo=c.algo, state=path, calls=c.calls)
    torch.save(payload, os.path.join(d, "cases.pt"))
    procs = start(d, "updates")
    try:
        want = {name: [(c.to_port(js), js) for js in
                       sharded_jax(c.jfn, c.jstate, c.jinputs)]
                for name, c in cases.items()}
    finally:
        finish(procs)
    out = {}
    for name, c in cases.items():
        out[name] = [(load_checkpoint(
            os.path.join(d, f"out_{name}_{r}.pt"),
            c.algo.init(torch.Generator().manual_seed(0))),
            *want[name][r]) for r in range(2)]
    return out


def modules_of(state, path: str = "state"):
    """(path, module) for every ``nn.Module`` of a learner state."""
    if isinstance(state, torch.nn.Module):
        yield path, state
    elif dataclasses.is_dataclass(state) and not isinstance(state, type):
        for f in dataclasses.fields(state):
            yield from modules_of(getattr(state, f.name), f"{path}.{f.name}")
    elif isinstance(state, (list, tuple)):
        for i, v in enumerate(state):
            yield from modules_of(v, f"{path}[{i}]")


def assert_nets_close(got, want, what: str, lr: float) -> None:
    """Every net of two port learner states within ATOL, bar one element in
    10,000 and none past ``lr`` (Adam's first step on a gradient at the
    float noise floor, as in ``test_torch_maddpg.assert_states_close``)."""
    diffs = []
    pairs = list(zip(modules_of(got), modules_of(want), strict=True))
    assert pairs, what
    for (path, net), (_, ref) in pairs:
        g, w = net.state_dict(), ref.state_dict()
        assert sorted(g) == sorted(w), f"{what}: {path}"
        for k in w:
            if not w[k].is_floating_point():
                continue
            diff = (g[k].double() - w[k].double()).abs().flatten()
            assert float(diff.max()) <= lr, (
                f"{what}: {path}.{k} max {float(diff.max())}")
            diffs.append(diff)
    d = torch.cat(diffs)
    past = int((d > ATOL).sum())
    assert past <= d.numel() // 10_000, (
        f"{what}: {past} of {d.numel()} past {ATOL} (max {float(d.max())})")


def assert_stats_close(got, want, what: str) -> None:
    """The running statistics ``mean``, ``var`` and ``count`` of two
    normalizers at rtol 1e-5 / atol 1e-6."""
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(
            getattr(got, k).numpy(), np.asarray(getattr(want, k)),
            rtol=1e-5, atol=1e-6, err_msg=f"{what} {k}")
