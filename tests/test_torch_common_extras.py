"""The last public names of the port: ``explained_variance`` and
``global_grad_norm`` (``algos/common.py``) against the JAX package's on
numpy-seeded inputs, within 1e-6; and the package's precision knob,
``FREERL_MATMUL_PRECISION``, read at import (each name in a subprocess of
its own, all of them started together), with the ENVELOPE branch of
``cli.build``, which forces full float32 unless the variable is set."""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.algos import common as jax_common
from freerl_tpu_torch.algos.common import (explained_variance,
                                           global_grad_norm)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n, noise", [(1, 0.0), (64, 0.3), (4096, 2.0),
                                      (64, 0.0)])
def test_explained_variance_matches_jax(n, noise):
    rng = np.random.default_rng(n)
    returns = rng.normal(size=n).astype(np.float32) * 3.0 + 1.0
    values = (returns + noise * rng.normal(size=n)).astype(np.float32)
    got = explained_variance(torch.from_numpy(returns),
                             torch.from_numpy(values))
    want = jax_common.explained_variance(jnp.asarray(returns),
                                         jnp.asarray(values))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_global_grad_norm_matches_jax():
    rng = np.random.default_rng(0)
    shapes = {"w1": (8, 128), "b1": (128,), "w2": (128, 4), "b2": (4,)}
    grads = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
    want = float(jax_common.global_grad_norm(
        {"dense": {k: jnp.asarray(v) for k, v in grads.items()}}))
    as_torch = {k: torch.from_numpy(v) for k, v in grads.items()}
    for form in (list(as_torch.values()), as_torch, {"dense": as_torch}):
        np.testing.assert_allclose(float(global_grad_norm(form)), want,
                                   **TOL)
    # a module: its parameters' .grad, the unset ones left out
    net = torch.nn.Sequential(torch.nn.Linear(8, 128),
                              torch.nn.Linear(128, 4),
                              torch.nn.Linear(4, 4))
    for p, g in zip(net.parameters(), (grads["w1"].T, grads["b1"],
                                       grads["w2"].T, grads["b2"])):
        p.grad = torch.from_numpy(np.ascontiguousarray(g))
    np.testing.assert_allclose(float(global_grad_norm(net)), want, **TOL)
    assert float(global_grad_norm([])) == float(
        jax_common.global_grad_norm([])) == 0.0


# ---------------------------------------------------------------------------
# the precision knob
# ---------------------------------------------------------------------------
FLAGS = ("import json, torch; print(json.dumps(["
         "torch.get_float32_matmul_precision(), "
         "torch.backends.cuda.matmul.allow_tf32, "
         "torch.backends.cudnn.allow_tf32]))")
IMPORT = "import freerl_tpu_torch; " + FLAGS
# TF32 on by hand, then the CLI's ENVELOPE branch
ENVELOPE = (
    "import torch; torch.backends.cuda.matmul.allow_tf32 = True; "
    "torch.backends.cudnn.allow_tf32 = True; "
    "from freerl_tpu_torch.cli import build, parser; "
    "build(parser().parse_args(['--algo', 'ENVELOPE', '--env_name', "
    "'deep-sea-treasure-v0', '--num_envs', '2', '--buffer_size', '64', "
    "'--device', 'cpu'])); " + FLAGS)

CASES = {
    "unset": (None, IMPORT, ["highest", False, True]),
    "float32": ("float32", IMPORT, ["highest", False, False]),
    "highest": ("highest", IMPORT, ["highest", False, False]),
    "tensorfloat32": ("tensorfloat32", IMPORT, ["high", True, True]),
    "high": ("high", IMPORT, ["high", True, True]),
    "bfloat16": ("bfloat16", IMPORT, ["medium", True, True]),
    "fastest": ("fastest", IMPORT, ["medium", True, True]),
    "default": ("default", IMPORT, ["highest", False, True]),
    "bogus": ("bogus", IMPORT, None),
    "envelope unset": (None, ENVELOPE, ["highest", False, False]),
    "envelope tensorfloat32": ("tensorfloat32", ENVELOPE,
                               ["high", True, True]),
}


@pytest.fixture(scope="module")
def knob_runs():
    procs = {}
    for name, (value, code, _) in CASES.items():
        env = {k: v for k, v in os.environ.items()
               if k != "FREERL_MATMUL_PRECISION"}
        env["OMP_NUM_THREADS"] = "1"
        if value is not None:
            env["FREERL_MATMUL_PRECISION"] = value
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=120)
            out[name] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_matmul_precision_knob(knob_runs, name):
    rc, stdout, stderr = knob_runs[name]
    want = CASES[name][2]
    if want is None:
        assert rc != 0 and "ValueError" in stderr
        assert "FREERL_MATMUL_PRECISION='bogus'" in stderr
        return
    assert rc == 0, stderr[-2000:]
    assert json.loads(stdout.strip().splitlines()[-1]) == want
