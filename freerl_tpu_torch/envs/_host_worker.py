"""Torch-free worker entry for HostVecEnv's process pool (counterpart:
``freerl_tpu/envs/_host_worker.py``).

Kept free of torch imports, so each worker starts in ~100 ms and never
touches CUDA (see envs/host.py). Only numpy and the env's own modules are
imported here.
"""
from __future__ import annotations

import pickle

import numpy as np


def dumps(make_fn) -> bytes:
    """``make_fn`` as bytes for a worker: through cloudpickle where it
    imports (lambdas and closures go too), else through ``pickle``, which
    needs a callable defined at module level."""
    try:
        import cloudpickle
    except ImportError:
        cloudpickle = None
    try:
        if cloudpickle is not None:
            return cloudpickle.dumps(make_fn)
        return pickle.dumps(make_fn)
    except (pickle.PicklingError, AttributeError, TypeError) as err:
        raise TypeError(
            f"HostVecEnv(num_workers > 1) sends make_fn to its workers and "
            f"cannot pickle {make_fn!r}: without cloudpickle, make_fn must "
            f"be a function or class defined at module level") from err


def _close(env) -> None:
    """Close an env that has a ``close`` (a duck-typed one may not)."""
    close = getattr(env, "close", None)
    if close is not None:
        close()


def _step_envs(envs, actions, is_continue: bool):
    """Step each env once, resetting a finished one on the host: the true
    next obs, the post-reset carry obs, rewards, terminated, truncated."""
    next_obs, carry_obs, rewards, terms, truncs = [], [], [], [], []
    for e, a in zip(envs, actions):
        if not is_continue:
            a = int(a)
        o2, r, term, trunc, _ = e.step(a)
        o2 = np.asarray(o2, np.float32).reshape(-1)
        next_obs.append(o2)
        if term or trunc:
            o_new, _ = e.reset()
            carry_obs.append(np.asarray(o_new, np.float32).reshape(-1))
        else:
            carry_obs.append(o2)
        rewards.append(np.float32(r))
        terms.append(bool(term))
        truncs.append(bool(trunc))
    return (
        np.stack(next_obs), np.stack(carry_obs),
        np.asarray(rewards, np.float32),
        np.asarray(terms), np.asarray(truncs),
    )


def _reset_envs(envs, seed: int):
    """Reset env i with seed ``seed + i``; the (n, obs_dim) obs."""
    obs = []
    for i, e in enumerate(envs):
        o, _ = e.reset(seed=int(seed) + i)
        obs.append(np.asarray(o, np.float32).reshape(-1))
    return np.stack(obs)


def _worker_main(pipe, payload, n_local: int, is_continue: bool):
    """Worker process: owns n_local envs, steps them on command."""
    make_fn = pickle.loads(payload)     # cloudpickle's bytes load as well
    envs = [make_fn() for _ in range(n_local)]
    try:
        while True:
            cmd, data = pipe.recv()
            if cmd == "reset":
                pipe.send(_reset_envs(envs, data))
            elif cmd == "step":
                pipe.send(_step_envs(envs, data, is_continue))
            elif cmd == "close":
                break
    finally:
        for e in envs:
            _close(e)
        pipe.close()
