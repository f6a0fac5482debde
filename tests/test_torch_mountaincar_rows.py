"""The rows this slice adds to ``golden.JAX_PARITY``, against the JAX
package's ``golden.SPECS``: the MountainCar DQN trick matrix (each trick's
recipe, seeds and gate; the base row over its 3 seeds against JAX at this
commit only) and SAC Pendulum over 16 seeds from seed 0's start (C13)."""
import pytest
import torch

from freerl_tpu.train import golden as jax_golden
from freerl_tpu_torch.train import golden

torch.set_num_threads(1)

MC = [r for r in golden.JAX_PARITY if r.env == "MountainCar-v0"]
SAC16 = next(r for r in golden.JAX_PARITY
             if golden.row_key(r) == "Pendulum-v1/SAC_16_seed@jax_head")
GATE = ("window", "slack", "agg", "slack_mode", "overlap_gate", "floor")


def test_the_matrix_rows():
    """Every trick against the committed stack and against JAX at this
    commit, then the base row against JAX at this commit alone."""
    want = [f"MountainCar-v0/DQN_{t}_{10 if t == 'Noisy' else 3}_seed{ref}"
            for t in golden.MC_TRICKS for ref in ("", "@jax_head")]
    assert [golden.row_key(r) for r in MC] == want + [
        "MountainCar-v0/DQN_fixedreset_3_seed@jax_head"]
    assert {r.algo.removeprefix("DQN_").rsplit("_", 2)[0]
            for r in jax_golden.SPECS if r.env == "MountainCar-v0"} == set(
        golden.MC_TRICKS) | {"fixedreset"}


@pytest.mark.parametrize("row", MC, ids=golden.row_key)
def test_a_matrix_row_takes_its_specs_rows_recipe_and_gate(row):
    """The JAX SPECS row's recipe, seeds and gate; stacked smoothed, as
    the JAX package's ``regenerate`` stacks them; the JAX curve of its own
    stem."""
    stem = ("DQN_fixedreset_13_seed" if row.algo == "DQN_fixedreset_3_seed"
            else row.algo)
    spec = next(s for s in jax_golden.SPECS
                if (s.env, s.algo) == ("MountainCar-v0", stem))
    for f in GATE + ("regen", "regen_seeds"):
        assert getattr(row, f) == getattr(spec, f), f
    assert row.smooth and row.ref_path == f"MountainCar-v0/{row.algo}.npy"


def test_the_base_row_holds_three_seeds_against_jax_at_this_commit():
    """The committed ``DQN_fixedreset_13_seed`` is a best of 13 seeds: the
    base row's best of its 3 is held only against JAX's best of the same
    3, under ``--fixed_reset``."""
    base = [r for r in MC if "fixedreset" in r.algo]
    assert [(r.algo, r.ref, r.agg, r.regen_seeds) for r in base] == [
        ("DQN_fixedreset_3_seed", "jax_head", "best", (0, 10, 100))]
    assert "--fixed_reset" in base[0].regen and "--trick" not in base[0].regen


def test_sac_16_seed_row_pins_seed_0s_start():
    """``Pendulum-v1/SAC_16_seed@jax_head``: the r5 SAC recipe with
    ``--reset_seed 0`` over the 16 seeds, with the 1-seed rows' gate;
    every seed starts where seed 0 starts (theta 2.1508, the JAX package's
    start), and keeps its curve apart from the recipe without
    ``--reset_seed``."""
    one = next(r for r in golden.JAX_PARITY
               if golden.row_key(r) == "Pendulum-v1/SAC_1_seed@jax_head")
    assert SAC16.regen == tuple(golden.r5_argv("SAC_Pendulum", "{seed}")) + (
        "--reset_seed", "0")
    assert SAC16.regen_seeds == golden.DQN_LL_SEEDS16
    for f in GATE + ("smooth", "ref"):
        assert getattr(SAC16, f) == getattr(one, f), f
    start = golden.pinned_start(one, 0)
    assert [golden.pinned_start(SAC16, s) for s in SAC16.regen_seeds] == [
        start] * 16
    assert {golden.start_seed(SAC16, s) for s in SAC16.regen_seeds} == {0}
    assert golden.start_seed(one, 7) == 7
    assert golden.seed_file("r", SAC16, 3).endswith(
        "Pendulum-v1/seeds/SAC_reset0_seed_3.npy")
    assert golden.seed_file("r", one, 3).endswith(
        "Pendulum-v1/seeds/SAC_seed_3.npy")


def test_the_port_cli_prints_its_sumtree_launches(tmp_path, capsys,
                                                  monkeypatch):
    """The port's CLI prints the launches of the sum-tree kernel (B1) in
    the run, which ``golden.parse_run_log`` reads for the card runner's
    provenance: 0 under the CLI's PER, whose sampler is ``cumsum``, whatever
    was launched in the process before the run."""
    from freerl_tpu_torch import cli
    from freerl_tpu_torch.ops import sumtree

    monkeypatch.setattr(sumtree, "launches", 5)
    cli.run(["--algo", "DQN", "--env_name", "MountainCar-v0",
             "--max_episodes", "8", "--num_envs", "8", "--batch_size", "32",
             "--buffer_size", "4096", "--start_steps", "64", "--trick",
             "PER", "--results_root", str(tmp_path), "--no_tensorboard",
             "--device", "cpu"])
    got = golden.parse_run_log(capsys.readouterr().out)
    assert got["b1_launches"] == 0 and got["episodes"] >= 8
