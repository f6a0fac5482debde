"""C16's step-by-step check (``tests/_torch_c16_lockstep.py``): the
MountainCarContinuous PPO ObsNorm recipe run by the JAX package's own
pieces, the port's normalizer, policy, env step, GAE and update held to it
at every vector step and update. Here one short iteration (2 envs x 64
steps) on the CPU, where every quantity must agree, and the same with a
fault put into the port's normalizer, which the check must name; then the
committed record of the recipe's 40 iterations at seed 0
(``results/torch/c16_lockstep.json``), whose verdicts must follow the rule
from its own numbers."""
import json
import os

import numpy as np
import pytest
import torch

from freerl_tpu_torch.core import normalization
from freerl_tpu_torch.train import golden
from tests import _torch_c16_lockstep as lockstep

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_one_short_iteration_agrees():
    """2 envs x 64 vector steps and one update: the normalizer's stats and
    normalized observations, the policy's actions and log-probs within
    ``RTOL`` of their scale, the env's observations within
    ``golden.START_ULPS`` ulps of its bounds, GAE within ``RTOL``, the
    update within the parity tests' tolerance; the reset batch agrees
    too."""
    out = lockstep.lockstep(1, seed=0, num_envs=2, horizon=128)
    (row,) = out["rows"]
    assert (out["vector_steps"], out["num_envs"]) == (64, 2)
    assert max(out["reset"].values()) <= lockstep.RTOL
    for k in ("stats_rel", "normalized_rel", "env_a_rel", "stored_a_rel",
              "logp_rel", "gae_adv_rel", "gae_target_rel"):
        assert row[k] <= lockstep.RTOL, k
    assert row["env_ulps"] <= golden.START_ULPS
    assert row["env_flags_differ"] == 0
    assert row["params_past_atol"] * lockstep.PAST_ONE_IN <= \
        row["params_total"] and row["params_abs"] <= 1e-3
    assert (row["steps"], row["gae"], row["update"]) == ("within",) * 3
    assert lockstep.verdict(out["rows"]) == "agree"


def test_a_fault_in_the_normalizer_is_named(monkeypatch):
    """The port's running variance folded without the batch's own
    variance: the steps read ``fault`` and so does the verdict."""
    update = normalization.RunningMeanStd.update

    def faulty(self, batch, axis_name=None):
        new = update(self, batch, axis_name)
        new.var = new.var * 1.001
        return new

    monkeypatch.setattr(normalization.RunningMeanStd, "update", faulty)
    out = lockstep.lockstep(1, seed=0, num_envs=2, horizon=128)
    (row,) = out["rows"]
    assert row["stats_rel"] > lockstep.RTOL and row["steps"] == "fault"
    assert lockstep.verdict(out["rows"]) == "fault"


def test_scales_of_the_errors():
    """A value near zero is held at its quantity's scale, and the env's
    ulps at its bounds."""
    assert lockstep.rel_err([1e-9], [2e-9]) == pytest.approx(0.5)
    assert lockstep.rel_err([1e-9], [2e-9], 1.0) == pytest.approx(1e-9)
    assert lockstep.rel_err([0.0], [0.0]) == 0.0
    ulp = float(np.spacing(np.float32(0.07)))
    assert lockstep.env_ulps([[0.5, 1e-6 + ulp]], [[0.5, 1e-6]],
                             (1.2, 0.07)) == pytest.approx(1.0, rel=1e-3)


@pytest.fixture(scope="module")
def record():
    with open(os.path.join(ROOT, "results", "torch",
                           "c16_lockstep.json")) as f:
        return json.load(f)


def test_record_follows_the_rule(record):
    """The committed record: the recipe's 40 iterations at seed 0 (8 envs
    x 256 steps); each iteration's verdicts follow from its numbers
    (steps and GAE within ``RTOL`` and the env's ulps; an update within
    the parity tolerance, else in float64 within ``ATOL_F64`` (the rule),
    or within ``TWIN_FACTOR`` times the port's own one-ulp gap); the
    verdicts over all iterations follow from those."""
    assert record["recipe"] == lockstep.recipe_argv(0)
    assert (record["iterations"], record["vector_steps"],
            record["num_envs"]) == (40, 256, 8)
    rows = record["rows"]
    assert [r["iteration"] for r in rows] == list(range(1, 41))
    for r in rows:
        steps_ok = (max(r["stats_rel"], r["normalized_rel"], r["env_a_rel"],
                        r["stored_a_rel"], r["logp_rel"]) <= lockstep.RTOL
                    and r["env_ulps"] <= golden.START_ULPS
                    and r["env_flags_differ"] == 0)
        assert r["steps"] == ("within" if steps_ok else "fault")
        gae_ok = max(r["gae_adv_rel"], r["gae_target_rel"]) <= lockstep.RTOL
        assert r["gae"] == ("within" if gae_ok else "fault")
        within = (r["params_past_atol"] * lockstep.PAST_ONE_IN
                  <= r["params_total"] and r["params_abs"] <= 1e-3)
        if within:
            assert r["update"] == "within" and "update_rule" not in r
            continue
        f64, twin = r["params_f64_abs"], r["params_f64_twin_abs"]
        rule = "float32" if f64 <= lockstep.ATOL_F64 else "fault"
        assert r["update_rule"] == rule
        assert r["update"] == (rule if f64 <= lockstep.ATOL_F64 else
                               "float64 rounding" if f64
                               <= lockstep.TWIN_FACTOR * twin else "fault")
    assert record["verdict"] == lockstep.verdict(rows)
    assert record["verdict_rule"] == lockstep.verdict(rows, "update_rule")
    assert record["tolerances"]["twin_factor"] == lockstep.TWIN_FACTOR


def test_record_reads_as_ruled(record):
    """What the record says of C16: every vector step and GAE agree at
    every iteration; every update is within the parity tolerance or
    within float32 rounding of float64 but 11, whose float64 gap the
    port's own one-ulp nudge matches (the worst update's gap grows epoch by
    epoch beside the nudge's); the harness's eager JAX steps part from the
    JAX driver's scan at iteration 1's update, and the driver is the
    committed seed curve bit for bit."""
    rows = record["rows"]
    assert all(r["steps"] == "within" and r["gae"] == "within"
               for r in rows)
    assert sum(r["update"] == "float64 rounding" for r in rows) == 11
    assert record["verdict"] == "agree"
    assert record["verdict_rule"] == "fault"
    growth = record["growth"]["epochs"]
    assert [g["epochs"] for g in growth] == list(range(1, 11))
    assert growth[0]["f64"] < 1e-12 and growth[-1]["f64"] > 1e-3
    parted = record["parted"]
    assert parted["driver_is_committed"] is True
    assert parted["stats_part_at"] == 2
    first = parted["per_iteration"][0]
    assert first["stats_rel"] <= lockstep.RTOL and first["params_abs"] > 0
