"""The port's BipedalWalker-v3 calibration, the JAX package's checks
(tests/test_bipedal.py) run as one batch: with zero motor torque the
walker folds and the hull hits the ground for -100 (gym ~114 steps, the
JAX package ~101); under uniform random torques the mean return over three
episodes of at most 400 steps lies in -130..-80 (gym -99..-111).
"""
import numpy as np
import torch

from freerl_tpu_torch.envs import make

torch.set_num_threads(1)


def test_zero_torque_collapses_and_random_policy_scale():
    env = make("BipedalWalker-v3", device="cpu")
    g = torch.Generator().manual_seed(0)
    n_rand = 3
    s, _ = env.reset(env.draw_reset(n_rand + 1, g))
    ret = torch.zeros(n_rand + 1)
    done = torch.zeros(n_rand + 1, dtype=torch.bool)
    ended_at = torch.full((n_rand + 1,), -1)
    last_r = torch.zeros(n_rand + 1)
    for t in range(400):
        a = torch.rand(n_rand + 1, 4, generator=g) * 2 - 1
        a[n_rand] = 0.0                        # the last row: zero torque
        s, _, r, term, trunc = env.step(s, a)
        live = ~done
        ret = ret + torch.where(live, r, 0.0)
        last_r = torch.where(live, r, last_r)
        ended_at = torch.where(live & term, t, ended_at)
        done = done | term
        if bool(done.all()):
            break
    zero_t = int(ended_at[n_rand])
    print(f"zero torque: -100 at step {zero_t}; random returns "
          f"{ret[:n_rand].tolist()}, ended at {ended_at[:n_rand].tolist()}")
    assert bool(done[n_rand]) and float(last_r[n_rand]) == -100.0
    assert 20 < zero_t < 300
    assert -130 < float(ret[:n_rand].mean()) < -80, ret
    assert np.isfinite(ret.numpy()).all()
