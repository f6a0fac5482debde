"""The measurements that decide C12 and C13 (ROADMAP queue C), on the CPU:
a FrozenLake Q-net brought from JAX to the port
(``scripts/torch_c12_greedy.py``'s path) takes the JAX net's greedy action
in every state of the lake; C12's rule over greedy rates
(``scripts/torch_seed_spread.py:greedy_rule``) on fixed numbers; C13's
count of seeds on the second policy and Fisher's p of those counts
(``torch_seed_spread.py --below``)."""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy.stats import fisher_exact, mannwhitneyu

from freerl_tpu_torch import cli
from freerl_tpu_torch.train import golden
from scripts import torch_c12_greedy as c12
from scripts import torch_seed_spread as spread
from tests.test_torch_jax_head import _tree

torch.set_num_threads(1)


@pytest.mark.parametrize("init_seed", [0, 1, 2])
def test_a_jax_frozenlake_net_keeps_its_greedy_actions(init_seed, tmp_path):
    """The r5 FrozenLake recipe's net, built by the JAX CLI from a run's
    ``config.json`` as ``freerl_tpu/eval.py`` builds it, its Q-values a
    table drawn with numpy, then built by the port from the same
    ``config.json`` and given the JAX params (``c12.port_policy``): the
    same greedy action in each of the 16 states, the table's."""
    import jax
    import jax.numpy as jnp

    from freerl_tpu import eval as jeval
    from freerl_tpu.cli import build

    row = next(r for r in golden.JAX_PARITY
               if golden.row_key(r) == c12.ROW)
    argv = [a.format(seed=init_seed) for a in row.regen]
    with open(tmp_path / "config.json", "w") as f:
        json.dump(vars(cli.parser().parse_args(argv)), f)
    env, algo = build(jeval._build_args(SimpleNamespace(
        model_dir=str(tmp_path))))
    # a net whose Q-values at the 16 states (the obs is the state's index)
    # are a table drawn with numpy: hidden unit j is relu(s - j + 1), and
    # the head's weights are the table's second differences; the other
    # hidden units are zero, their head weights drawn
    rng = np.random.RandomState(init_seed)
    table = rng.normal(size=(16, 4))
    slope = np.diff(table, axis=0, prepend=0.0)
    params = jax.tree.map(np.asarray,
                          algo.init(jax.random.PRNGKey(init_seed)).params)
    hidden, head = params["Dense_0"]["Dense_0"], params["Dense_1"]["Dense_0"]
    n = hidden["bias"].shape[0]
    hidden["kernel"] = np.zeros((1, n), np.float32)
    hidden["kernel"][0, :16] = 1.0
    hidden["bias"] = np.zeros(n, np.float32)
    hidden["bias"][:16] = 1.0 - np.arange(16)
    head["kernel"] = rng.normal(size=(n, 4)).astype(np.float32)
    head["kernel"][:16] = np.diff(slope, axis=0, prepend=0.0)
    head["bias"] = np.zeros(4, np.float32)
    state = algo.init(jax.random.PRNGKey(init_seed)).replace(
        params=jax.tree.map(jnp.asarray, params))
    states = np.arange(16, dtype=np.float32)[:, None]
    want = np.asarray(algo.evaluate_action(state, jnp.asarray(states)))
    port_env, act_fn = c12.port_policy(str(tmp_path), params)
    got = act_fn(torch.from_numpy(states)).numpy()
    assert port_env.n_states == env.n_states == 16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, table.argmax(axis=1))


@pytest.mark.parametrize("port,jax,closes", [
    # alike: p 1.0, the best 0.02 apart
    ([0.10, 0.20, 0.30, 0.40], [0.12, 0.18, 0.32, 0.38], True),
    # every port rate below every JAX rate: p = 2 / C(8, 4) < 0.05
    ([0.01, 0.02, 0.03, 0.04], [0.30, 0.35, 0.40, 0.45], False),
    # alike but for JAX's best, 0.09 above the port's
    ([0.10, 0.20, 0.30, 0.40], [0.10, 0.20, 0.30, 0.49], False),
])
def test_greedy_rule_on_fixed_numbers(port, jax, closes):
    got = spread.greedy_rule(port, jax)
    want = mannwhitneyu(port, jax, alternative="two-sided").pvalue
    assert got["mannwhitney"]["p"] == pytest.approx(want)
    assert (got["best_port"], got["best_jax"]) == (max(port), max(jax))
    assert got["p_ok"] == (want >= 0.05)
    assert got["best_ok"] == (max(port) >= max(jax) - 0.08)
    assert got["closes"] is closes


def test_greedy_rule_reads_the_rates_file(tmp_path, capsys):
    path = tmp_path / "rates.json"
    with open(path, "w") as f:
        json.dump(dict(row=c12.ROW, seeds=[0, 1, 2], port=[0.1, 0.2, 0.3],
                       jax=[0.2, 0.3, 0.4]), f)
    assert spread.main(["--greedy", str(path)]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["rule"] == json.loads(json.dumps(spread.greedy_rule(
        [0.1, 0.2, 0.3], [0.2, 0.3, 0.4])))


def test_seeds_below_a_threshold_and_fishers_p(tmp_path, capsys):
    """C13's count: the seeds whose final-50 lies below -180 (on the second
    policy) on each side, and Fisher's exact p of the two counts."""
    _tree(tmp_path / "a", (0, 1, 2, 3), [-236.0, -129.0, -236.5, -128.0],
          [-900.0] * 4, [1, 2, 3, 4])
    _tree(tmp_path / "b", (0, 1, 2, 3), [-129.0, -128.5, -130.0, -236.0],
          [-900.0] * 4, [1, 2, 3, 4])
    assert spread.main(["--env", "Env-v0", "--stem", "DQN_3_seed", "--ours",
                        str(tmp_path / "a"), "--ref", str(tmp_path / "b"),
                        "--below", "-180"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert (got["port"]["below"], got["jax_head"]["below"]) == (2, 1)
    assert got["fisher_below"]["table"] == [[2, 2], [1, 3]]
    assert got["fisher_below"]["p"] == pytest.approx(
        fisher_exact([[2, 2], [1, 3]]).pvalue)


def test_c13_rows_are_underpowered_by_its_rule():
    """C13's rule over the committed curves: the 16-seed row passes, and
    neither the final-50s (Mann-Whitney) nor the counts of seeds on the
    second policy, below -180 (Fisher), differ at p < 0.05; so the two
    1-seed rows keep their gates, are held to FAIL under
    ``UNDERPOWERED`` and name the 16-seed row."""
    row = next(r for r in golden.JAX_PARITY
               if golden.row_key(r) == "Pendulum-v1/SAC_16_seed@jax_head")
    assert golden.check_against_jax(row)["status"] == "pass"
    got = spread.spread(golden.OURS_ROOT, golden.JAX_HEAD_ROOT,
                        "Pendulum-v1", "SAC_16_seed", below=-180.0)
    assert got["mannwhitney"]["final50"]["p"] >= spread.P_MIN
    assert got["fisher_below"]["p"] >= spread.P_MIN
    for key in ("Pendulum-v1/SAC_1_seed", "Pendulum-v1/SAC_1_seed@jax_head"):
        assert golden.UNDERPOWERED[key] == golden.row_key(row)
        assert golden.must_fail(key) and key not in golden.OPEN_FAULTS


def test_c12_rows_are_underpowered_by_its_rule():
    """C12's rule over the committed greedy rates: the two evaluators
    agree within 0.07 a net, and the rule holds, so the two FrozenLake
    ``@jax_head`` rows keep their gates, are held to FAIL under
    ``UNDERPOWERED`` and name the rates' file."""
    path = "results/torch/c12_greedy.json"
    with open(os.path.join(os.path.dirname(__file__), "..", path)) as f:
        rates = json.load(f)
    assert rates["n_episodes"] == c12.N_EPISODES == 1000
    assert rates["seed0"] == c12.SEED0 and len(rates["port"]) == 16
    gaps = np.abs(np.subtract(rates["jax"], rates["jax_own_evaluator"]))
    assert gaps.max() <= c12.AGREE
    assert spread.greedy_rule(rates["port"], rates["jax"])["closes"]
    for key in ("FrozenLake-v1/DQN_3_seed@jax_head",
                "FrozenLake-v1/DQN_16_seed@jax_head"):
        assert golden.UNDERPOWERED[key] == path
        assert golden.must_fail(key) and key not in golden.OPEN_FAULTS
    assert not [k for k in golden.OPEN_FAULTS if k.startswith("FrozenLake")]
    assert "C12" not in golden.OPEN_FAULTS.values()
