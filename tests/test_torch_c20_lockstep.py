"""C20's step-by-step check (``tests/_torch_c20_lockstep.py``): the GAIL
script's PPO expert on Pendulum-v1 and one GAIL iteration, run by the JAX
package's own pieces, the port's starts, policy, env step, reward scaling,
normalizer, GAE, lr, update, D step and relabel held to them. Here one
short iteration of each (2 envs x 64 steps) on the CPU, where every
quantity must agree; the same with a fault put into the port's
``RewardScaling``, which the check must name; then the committed record
(``results/torch/c20_lockstep.json``), whose verdicts must follow from its
own numbers."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freerl_tpu.envs import make as jax_make
from freerl_tpu_torch.core import normalization
from freerl_tpu_torch.envs import make
from freerl_tpu_torch.envs.classic import PendulumState, fma32
from freerl_tpu_torch.train import golden
from tests import _torch_c20_lockstep as lockstep

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_RELS = ("policy_rel", "scaling_ret_rel", "scaling_stats_rel",
             "scaled_rel", "norm_stats_rel", "normalized_rel")


def test_one_short_iteration_agrees():
    """One expert iteration and one GAIL iteration at 2 envs x 64 steps:
    every step's quantities within their tolerances, GAE, the lr and the
    update within, the D step and the relabel within; no fault named."""
    out = lockstep.lockstep(1, seed=0, num_envs=2, expert_horizon=128,
                            gail_horizon=128, n_expert=512)
    (upd,) = out["expert"]
    gail = out["gail"]
    assert (out["vector_steps"], out["num_envs"]) == (64, 2)
    assert len(upd["step_rows"]) == len(gail["step_rows"]) == 64
    assert out["reset_ulps"] <= golden.START_ULPS
    assert out["reset_norm_rel"] <= lockstep.RTOL
    for r in upd["step_rows"]:
        assert max(r[k] for k in STEP_RELS) <= lockstep.RTOL, r
        assert max(r["reset_ulps"], r["env_ulps"]) <= golden.START_ULPS
        assert r["env_flags"] == 0 and r["verdict"] == "within"
    for row in (upd, gail):
        assert (row["steps"], row["gae"], row["update"]) == ("within",) * 3
        assert row["lr_rel"] <= lockstep.RTOL
    assert upd["lr"] == pytest.approx(3e-4) and gail["lr"] == \
        pytest.approx(1e-4)
    assert (gail["d_step"], gail["relabel"]) == ("within", "within")
    assert out["first_fault"] is None
    assert (out["verdict"], out["verdict_rule"]) == ("agree", "agree")


def test_a_fault_in_reward_scaling_is_named(monkeypatch):
    """The port's ``RewardScaling`` folding the raw reward into its stats
    in place of the running return: the check names it at its first
    step past the first (where the two are still one)."""
    call = normalization.RewardScaling.__call__

    def faulty(self, reward, episode_done, axis_name=None):
        new, _ = call(self, reward, episode_done, axis_name)
        new.stats = self.stats.update(reward)
        return new, reward / torch.sqrt(new.stats.var + 1e-8)

    monkeypatch.setattr(normalization.RewardScaling, "__call__", faulty)
    cf = lockstep.configs(0, 3000, 2, 128, 128)
    ex = lockstep.expert_lockstep(cf, 1, 0)
    out = dict(reset_ulps=ex["reset_ulps"],
               reset_norm_rel=ex["reset_norm_rel"], expert=ex["updates"])
    assert lockstep.first_fault(out) == dict(
        phase="expert", iteration=1, step=2, quantity="scaling_stats_rel")
    assert ex["updates"][0]["steps"] == "fault"


def test_pendulum_step_rounds_as_jax():
    """The fault the record first named: at large |theta| the port's
    Pendulum observations parted from JAX's by up to 16 ulps of their
    bound, because XLA fuses ``th + newthdot * dt`` (and the cost's and
    the speed's multiply-adds) into one rounding where the port rounded
    twice. From the same states and actions (|theta| up to 60 rad): the
    cost bit-equal, and the new angle bit-equal wherever the new speed is
    (the speed itself may part by the ulp that the two libraries' ``sin``
    may round apart)."""
    jenv, env = jax_make("Pendulum-v1"), make("Pendulum-v1", device="cpu")
    rng = np.random.RandomState(0)
    n = 4096
    th = rng.uniform(-60, 60, n).astype(np.float32)
    thdot = rng.uniform(-8, 8, n).astype(np.float32)
    u = rng.uniform(-3, 3, (n, 1)).astype(np.float32)
    js, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), n))
    js = js.replace(theta=jnp.asarray(th), theta_dot=jnp.asarray(thdot))
    jnew, _, jr, _, _ = jax.jit(jax.vmap(jenv.step))(
        js, jnp.asarray(u), jax.random.split(jax.random.PRNGKey(1), n))
    new, _, r, _, _ = env.step(
        PendulumState(torch.from_numpy(th), torch.from_numpy(thdot),
                      torch.zeros(n, dtype=torch.int32)),
        torch.from_numpy(u), None)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    same = new.theta_dot.numpy() == np.asarray(jnew.theta_dot)
    assert same.mean() > 0.9
    np.testing.assert_array_equal(new.theta.numpy()[same],
                                  np.asarray(jnew.theta)[same])


def _round_once(a, b, c) -> np.float32:
    """``a * b + c`` rounded once to float32, from the exact rational
    value (ties to even)."""
    from fractions import Fraction

    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(exact))
    near = [f, np.nextafter(f, np.float32(np.inf)),
            np.nextafter(f, np.float32(-np.inf))]
    return min(near, key=lambda x: (abs(Fraction(float(x)) - exact),
                                    int(np.array(x).view(np.int32)) & 1))


def test_fma32_rounds_once():
    """``classic.fma32`` against the exact value rounded once, over
    magnitudes 1e-8 to 1e3."""
    rng = np.random.RandomState(0)
    n = 2000

    def draw():
        return (rng.randn(n) * 10.0 ** rng.uniform(-8, 3, n)).astype(
            np.float32)

    a, b, c = draw(), draw(), draw()
    got = fma32(torch.from_numpy(a), torch.from_numpy(b),
                torch.from_numpy(c)).numpy()
    want = np.array([_round_once(*x) for x in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    # a number as the first factor, as Pendulum's step passes its constants
    np.testing.assert_array_equal(
        fma32(0.05, torch.from_numpy(b), torch.from_numpy(c)).numpy(),
        [_round_once(np.float32(0.05), y, z) for y, z in zip(b, c)])


@pytest.fixture(scope="module")
def record():
    with open(os.path.join(ROOT, "results", "torch",
                           "c20_lockstep.json")) as f:
        return json.load(f)


def _update_verdict(r, lr):
    if r["lr_rel"] > lockstep.RTOL:
        return "fault"
    within = (r["params_past_atol"] * lockstep.PAST_ONE_IN
              <= r["params_total"] and r["params_abs"] <= lr)
    if within:
        return "within"
    f64, twin = r["params_f64_abs"], r["params_f64_twin_abs"]
    return ("float32" if f64 <= lockstep.ATOL_F64 else "float64 rounding"
            if f64 <= lockstep.TWIN_FACTOR * twin else "fault")


def test_record_follows_the_rule(record):
    """The committed record: the full recipe (8 envs, horizon 400, then
    GAIL at 2048 on 20,000 expert pairs), a verdict per vector step and
    per update, each following from its numbers, and the verdicts and the
    first fault following from those."""
    assert record["recipe"]["horizon"] == 400
    assert record["gail_recipe"]["horizon"] == 2048
    assert (record["vector_steps"], record["num_envs"]) == (50, 8)
    assert record["iterations"] >= 3
    assert record["gail"]["n_expert"] == lockstep.N_EXPERT
    assert len(record["gail"]["step_rows"]) == 256
    rows = ([(u, record["recipe"]["actor_lr"]) for u in record["expert"]]
            + [(record["gail"], record["gail_recipe"]["actor_lr"])])
    for upd, lr in rows:
        for r in upd["step_rows"]:
            assert r["verdict"] == lockstep.step_verdict(r)
        assert upd["steps"] == ("within" if all(
            r["verdict"] == "within" for r in upd["step_rows"]) else "fault")
        assert upd["update"] == _update_verdict(upd, lr)
        gae_ok = max(upd["gae_adv_rel"],
                     upd["gae_target_rel"]) <= lockstep.RTOL
        assert upd["gae"] == ("within" if gae_ok else "fault")
    assert [u["iteration"] for u in record["expert"]] == list(
        range(1, record["iterations"] + 1))
    assert record["first_fault"] == lockstep.first_fault(record)
    assert record["verdict"] == lockstep.verdict(record)
    assert record["verdict_rule"] == lockstep.verdict(record, "update_rule")


def test_record_reads_as_ruled(record):
    """What the record says of C20: over the expert's first 8 iterations
    (its first 16 episodes, where the two packages' curves part at p
    0.010) and GAIL's first iteration, nothing parts: no fault is named,
    every vector step, GAE, lr, update, D step and relabel is within its
    tolerance. The harness's eager JAX steps give the kept JAX seed-0
    expert curve's first 8 episodes to 0.03 (the JAX training loop runs
    them in one scan); past them the two part."""
    assert record["first_fault"] is None
    assert (record["verdict"], record["verdict_rule"]) == ("agree",
                                                           "agree")
    assert record["iterations"] == 8
    rows = record["expert"] + [record["gail"]]
    assert all(u["steps"] == u["gae"] == u["update"] == "within"
               for u in rows)
    assert [u["episodes"] for u in record["expert"]] == [0] * 3 + [8] * 4 \
        + [16]
    assert record["curve"]["episodes"] == 16
    want = lockstep.committed_expert_curve(0)[:8]
    np.testing.assert_allclose(record["returns"][:8], want, atol=0.03)
