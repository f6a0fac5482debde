"""Golden-curve regression harness (counterpart:
``freerl_tpu/train/golden.py``; the specs, gates and acceptance rules are
the JAX package's, copied; ``check`` and ``check_all`` are numpy only).

The port's artifacts live in a tree of their own, ``results/torch/``, which
mirrors the JAX package's ``results/``: ``regenerate`` writes the port's
curves under ``results/torch/learning_curves/`` (``OURS_ROOT``), ``check``
reads "ours" from there, and a scalar gate's ``results/...`` glob is
resolved under ``results/torch/``. So a port curve that was never
regenerated reads as missing, and no committed artifact of the JAX package
is written over or read as the port's.

The reference's empirical validation is its committed 3-seed learning
curves (SURVEY §4.2: ``*_seed_<s>.npy`` -> ``plot_learning_curves.py`` ->
``<algo>_N_seed.npy``). This harness makes that protocol a regression
test: each :class:`GoldenSpec` names one of our curve artifacts (under
``OURS_ROOT``), the matching reference artifact, and an acceptance rule
expressed in final-window means.

Acceptance semantics: our final-``window`` mean must be >= the reference's
final-window mean minus ``slack`` (one-sided — beating the reference is
always a pass; regressing below its seed spread fails).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
from typing import List, Optional

import numpy as np

OURS_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "results",
                         "torch", "learning_curves")
# the reference FreeRL tree, checked out beside the packages; where it is
# absent, every reference curve reads as missing
REF_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "reference")


@dataclasses.dataclass(frozen=True)
class GoldenSpec:
    env: str
    algo: str                      # our artifact stem, e.g. 'DQN_3_seed'
    ref_path: str                  # relative to the reference root
    # multi-run reference: the reference commits per-run artifacts (e.g.
    # MADDPG_1..3/*_N_5.npy, each (n_agents, episodes)) rather than one
    # stacked (seeds, episodes) file. Each path contributes ONE reference
    # "seed": its final-window mean over all agents. Overrides ref_path.
    ref_paths: tuple = ()
    window: int = 50               # final-N episode window
    slack: float = 0.0             # tolerance below the reference mean
    note: str = ""
    # from-scratch regeneration recipe: CLI argv per seed ('{seed}'
    # placeholder), consumed by ``regenerate()`` / ``--regenerate``
    regen: tuple = ()
    regen_seeds: tuple = (0,)
    # absolute final-window bar, for algorithms the reference ships
    # WITHOUT a committed curve (it publishes only converged lrs,
    # README.md:149-158): the artifact must exist and its final-window
    # mean must clear the floor. Applied in addition to the reference
    # gates when both are present.
    floor: Optional[float] = None
    # cross-seed aggregation for the acceptance statistic: 'mean'
    # (default) or 'best'. 'best' is for bimodal solve-lottery configs
    # (e.g. Noisy MountainCar) where the honest claim is "when it
    # solves, it matches the reference's solved seeds" — see the spec
    # note for the evidence that the reference itself is a lottery.
    agg: str = "mean"
    # pending=True: the regen recipe exists but the artifact has not yet
    # been produced (e.g. a multi-hour run that did not fit the round).
    # A missing artifact reports status 'pending' (skipped by the test
    # with a visible reason); an EXISTING artifact is still gated
    # normally — pending never excuses a bad curve, only an absent one.
    pending: bool = False
    # seed-overlap gate switch: the best-ours >= worst-ref check assumes
    # both sides sample the same outcome distribution. Mixed-competitive
    # self-play rows (adversary vs good agents) converge to an
    # implementation-specific equilibrium advantage, where a tight draw
    # cluster NEAR the reference's range is the meaningful statistic —
    # setting this False requires a note documenting the evidence.
    overlap_gate: bool = True
    # slack semantics for the mean gate:
    #   'abs'  — fixed ``slack`` below the reference mean (default);
    #   'dist' — distribution-aware gate for bimodal final windows
    #            (catastrophic forgetting): pass iff our mean is within
    #            ONE reference cross-seed std of the reference mean, OR
    #            at least one of our seeds beats the reference MEAN
    #            outright. No hand slack wider than the reference's own
    #            seed spread can sneak through (requires a multi-seed
    #            reference artifact).
    slack_mode: str = "abs"


# reference protocol (DQN_file/DQN.py:227-253 argparse defaults): 500
# episodes, batch 256, buffer 1e6, start_steps 500, 1 update per env
# step (kept exactly: 8 envs x updates_per_burst 8)
_DQN_LL = ("--algo", "DQN", "--env_name", "LunarLander-v2",
           "--max_episodes", "500", "--num_envs", "8",
           "--updates_per_burst", "8", "--batch_size", "256",
           "--buffer_size", "1000000", "--start_steps", "500",
           "--seed", "{seed}")

SPECS: List[GoldenSpec] = [
    GoldenSpec(
        "LunarLander-v2", "DQN_3_seed",
        "DQN_file/learning_curves/LunarLander-v2/DQN_3_seed.npy",
        # ref per-seed final-50: 235/228/-92 (mean 123); ours (regen with
        # the reference-default batch 256): 125/228/199 (mean 164) — above
        # the reference; slack covers regen seed variance only
        slack=50.0, note="ours 164 vs ref 123 (per-seed 125/228/199)",
        regen=_DQN_LL, regen_seeds=(0, 10, 100),
    ),
    GoldenSpec(
        "BipedalWalker-v3", "DQN_3_seed",
        "DQN_file/learning_curves/BipedalWalker-v3/DQN_3_seed.npy",
        slack=25.0,
    ),
    GoldenSpec(
        # final-50 on CartPole DQN is bimodal in BOTH impls (catastrophic
        # forgetting): ref per-seed 498/468/213, ours 102/128/476. The
        # 'dist' gate replaces the old hand slack of 170 (> the ref's own
        # cross-seed std of 128): passes here because our best seed (476)
        # beats the reference MEAN (393), i.e. our solved mode matches
        # theirs, and both overlap gates hold.
        "CartPole-v1", "DQN_3_seed",
        "DQN_file/learning_curves/CartPole-v1/DQN_3_seed.npy",
        slack_mode="dist",
        note="bimodal final-50 in both impls; dist gate; regen is the "
             "reference's fixed-reset protocol (DQN.py:334)",
        regen=("--algo", "DQN", "--env_name", "CartPole-v1",
               "--max_episodes", "500", "--num_envs", "8",
               "--updates_per_burst", "8", "--batch_size", "256",
               "--buffer_size", "1000000", "--start_steps", "500",
               "--fixed_reset", "--seed", "{seed}"),
        regen_seeds=(0, 10, 100),
    ),
    GoldenSpec(
        "Pendulum-v1", "DQN_3_seed",
        "DQN_file/learning_curves/Pendulum-v1/DQN_3_seed.npy",
        slack=50.0, note="dis_to_con 16 bins (README protocol)",
        regen=("--algo", "DQN", "--env_name", "Pendulum-v1",
               "--dis_to_con", "--max_episodes", "500", "--num_envs", "8",
               "--updates_per_burst", "8", "--batch_size", "256",
               "--buffer_size", "1000000", "--start_steps", "500",
               "--seed", "{seed}"),
        regen_seeds=(0, 10, 100),
    ),
    GoldenSpec(
        "CartPole-v1", "REINFORCE_3_seed",
        "REINFORCE_file/learning_curves/CartPole-v1/REINFORCE_3_seed.npy",
        slack=50.0, note="1000-episode Monte-Carlo protocol",
        # the reference's exact cadence: one Adam step per finished
        # episode, lr 1e-3 (algos/reinforce.py segments the window into
        # episodes). num_envs=1 + horizon 1024 (> 2x CartPole's 500-step
        # cap) keeps the dropped window-tail small. Measured final-50
        # 465.6 at seed 0 vs the reference's 472.
        regen=("--algo", "REINFORCE", "--env_name", "CartPole-v1",
               "--max_episodes", "1000", "--num_envs", "1",
               "--horizon", "1024", "--lr", "1e-3", "--seed", "{seed}"),
        regen_seeds=(0, 10, 100),
    ),
] + [
    # the DQN trick-ablation matrix (README.md:72 compare chart): one spec
    # per trick variant on MountainCar-v0, 500 ep x 3 seeds. The BASE
    # variant regen adds --fixed_reset: the reference trains every
    # episode from one pinned start (DQN.py:334), and on exploration-
    # critical MountainCar that protocol is load-bearing for the
    # no-trick agent (r4's random-reset base sat at -164.7 vs the ref's
    # -136.0 while every trick variant beat its ref column — the trick
    # variants keep their random-reset curves, a strictly harder
    # protocol they win anyway). Base slack shrinks 30 -> 10.
    GoldenSpec(
        "MountainCar-v0",
        ("DQN_fixedreset_13_seed" if t == ""
         else f"DQN_{t}_3_seed"),
        f"DQN_file/learning_curves/MountainCar-v0/"
        f"DQN{('_' + t) if t else ''}_3_seed.npy",
        slack=30.0,
        agg=("best" if t == "" else "mean"),
        note=("base DQN is a fixed-start bootstrap lottery in our PRNG "
              "space: 13-seed pre-declared sweep solves 7/13 to the "
              "reference band (-115.6..-164.9; ref commits "
              "-115/-139/-153 and its code rerun HERE lands "
              "-129/-140/-155, 3/3 — results/reference_rerun/"
              "ref_dqn_rerun.log); best-seed gate, Noisy-row precedent"
              if t == "" else ""),
        regen=("--algo", "DQN", "--env_name", "MountainCar-v0",
               "--max_episodes", "500", "--num_envs", "8",
               "--updates_per_burst", "8", "--batch_size", "256",
               "--buffer_size", "1000000", "--start_steps", "500",
               "--seed", "{seed}")
        + (("--fixed_reset",) if t == "" else ())
        + (
            ("--trick",) + (
                ("Double", "Dueling", "PER", "Noisy", "N_Step",
                 "Categorical") if t == "Rainbow" else (t,)
            ) if t else ()
        ),
        regen_seeds=(0, 10, 100),
    )
    for t in ("", "Double", "Dueling", "PER", "N_Step",
              "Categorical", "Rainbow")
] + [
    # Noisy alone is a bimodal solve lottery on MountainCar: its
    # exploration is noise-dithered argmax, and whether the Q landscape
    # differentiates before it flattens is seed luck. Evidence committed
    # under results/reference_rerun/: the reference's OWN code run in
    # this environment solves 3/7 fresh seeds (its committed artifact is
    # itself 2/3 with one -200 seed); our implementation solves at the
    # same per-seed quality (-88..-111 vs its -89/-119) with matching
    # update dynamics on identical data. The spec therefore runs a
    # pre-declared 10-seed sweep (seeds 0-9, the reference's single-env
    # fixed-reset protocol) and gates on the BEST seed: when it solves,
    # it must match the reference's solved seeds.
    GoldenSpec(
        "MountainCar-v0", "DQN_Noisy_10_seed",
        "DQN_file/learning_curves/MountainCar-v0/DQN_Noisy_3_seed.npy",
        # slack = the spread of the reference's own SOLVED seeds
        # (-89.4 vs -119.5 = 30.1), not a hand number: "when it solves,
        # it lands inside the reference's solved band". Solve rates for
        # the record: ours 1/10; the reference's code rerun here 3/7;
        # its committed artifact 2/3 (results/reference_rerun/).
        slack=30.0, agg="best",
        note="bimodal solve lottery (results/reference_rerun/); best-seed "
             "gate, slack = ref solved-seed spread; solve rate ours 1/10 "
             "vs ref-rerun 3/7",
        regen=("--algo", "DQN", "--env_name", "MountainCar-v0",
               "--max_episodes", "500", "--num_envs", "1",
               "--fixed_reset", "--batch_size", "256",
               "--buffer_size", "1000000", "--start_steps", "500",
               "--seed", "{seed}", "--trick", "Noisy"),
        regen_seeds=tuple(range(10)),
    ),
] + [
    GoldenSpec(
        "MountainCarContinuous-v0", "PPO_ObsNorm_3_seed",
        "PPO_file/learning_curves/MountainCarContinuous-v0/"
        "PPO_ObsNorm_3_seed.npy",
        # regen: per-seed final-50 94.5/94.7/93.6 vs the reference's 93.9
        slack=5.0,
        regen=("--algo", "PPO", "--env_name", "MountainCarContinuous-v0",
               "--max_episodes", "500", "--num_envs", "8",
               "--horizon", "2048", "--trick", "ObsNorm",
               "--seed", "{seed}"),
        regen_seeds=(0, 10, 100),
    ),
    GoldenSpec(
        "MountainCarContinuous-v0", "SAC_OUNoise_1_seed",
        "SAC_file/learning_curves/MountainCarContinuous-v0/"
        "SAC_OUNoise_1_seed.npy",
        slack=5.0,
    ),
    GoldenSpec(
        "MountainCarContinuous-v0", "TD3_1_seed",
        "TD3_file/learning_curves/MountainCarContinuous-v0/TD3_1_seed.npy",
        slack=5.0,
    ),
    GoldenSpec(
        # reference protocol: DDPG_simple with gauss_sigma=1, batch 64
        # (DDPG_file/DDPG_simple.py:258-261 comments name the
        # MountainCarContinuous overrides), 1 committed seed
        "MountainCarContinuous-v0", "DDPG_simple_1_seed",
        "DDPG_file/learning_curves/MountainCarContinuous-v0/"
        "DDPG_simple_1_seed.npy",
        slack=2.0,
        regen=("--algo", "DDPG", "--env_name", "MountainCarContinuous-v0",
               "--max_episodes", "500", "--num_envs", "8",
               "--batch_size", "64", "--gauss_sigma", "1.0",
               "--seed", "{seed}"),
    ),
    GoldenSpec(
        "MountainCarContinuous-v0", "DDPG_OUNoise_1_seed",
        "DDPG_file/learning_curves/MountainCarContinuous-v0/"
        "DDPG_simple_1_seed.npy",
        # measured deficit is 3.9 (86.0 vs 89.9) on a ~90-scale return;
        # 5.0 bounds it without the old 10-point blank check
        slack=5.0, note="OU-noise supplement variant (ours 86.0)",
    ),
    GoldenSpec(
        # 3-seed regen of the OUNoise variant (regenerate() names the
        # artifact <label>_<n_seeds>_seed.npy, hence the separate row);
        # best-seed gate targets closing the 1-seed row's 3.9 deficit
        "MountainCarContinuous-v0", "DDPG_OUNoise_3_seed",
        "DDPG_file/learning_curves/MountainCarContinuous-v0/"
        "DDPG_simple_1_seed.npy",
        # r5 fixed-reset regen (the reference's actual protocol) landed
        # 89.3/87.0/85.6 — best within 0.6 of the 89.9 DDPG_simple
        # curve the row borrows (the reference commits no OUNoise curve
        # of its own); the old random-reset runs sat at ~86
        slack=1.0, agg="best",
        note="fixed-reset 3-seed OUNoise regen (89.3/87.0/85.6), "
             "best-seed vs the reference's DDPG_simple curve",
        regen=("--algo", "DDPG", "--env_name", "MountainCarContinuous-v0",
               "--max_episodes", "500", "--num_envs", "8",
               "--batch_size", "64", "--trick", "OUNoise",
               "--fixed_reset", "--seed", "{seed}"),
        regen_seeds=(0, 10, 100),
    ),
    GoldenSpec(
        "simple_spread_v3", "MADDPG_1_seed",
        "MADDPG_file/learning_curves/simple_spread_v3/MADDPG_1_seed.npy",
        slack=5.0,
    ),
    GoldenSpec(
        "simple_spread_v3", "MAPPO_1_seed",
        "MAPPO_file/learning_curves/simple_spread_v3/MAPPO_1_seed.npy",
        slack=5.0,
    ),
    GoldenSpec(
        "simple_spread_v3", "MASAC_1_seed",
        "MAAC_file/learning_curves/simple_spread_v3/MASAC_1_seed.npy",
        slack=10.0,
        note="600-ep short protocol; full protocol is MASAC_40k below",
    ),
    GoldenSpec(
        # the reference's committed MASAC curve IS its 40000-episode
        # lr=1e-4 run downsampled to 600 points (MAAC_file/README.md
        # "2025.3.22"); MASAC_40k_1_seed.npy is our 40k run in the same
        # format (scripts/train_spread.py + 600-bin means)
        "simple_spread_v3", "MASAC_40k_1_seed",
        "MAAC_file/learning_curves/simple_spread_v3/MASAC_1_seed.npy",
        slack=0.0, note="full 40k protocol: ours -7.6 vs ref -10.4",
    ),
    # ---- short-protocol (3-agent) MARL rows. NOTE: every committed
    # reference simple_spread artifact is an N=5 run (the `_N_5` suffix
    # MADDPG_simple.py:395 writes); these N=3 rows are therefore NOT
    # apples-to-apples with their ref columns (3 agents is the easier
    # task) — they are kept as short-protocol regression guards, and the
    # protocol-exact comparisons live in the *_N5 rows below.
    GoldenSpec(
        "simple_spread_v3", "MATD3_1_seed",
        "MADDPG_file/learning_curves/simple_spread_v3/MADDPG_1_seed.npy",
        slack=5.0, floor=-25.0,
        note="N=3 short-protocol guard (ref col is an N=5 run; "
             "protocol-exact gate: MATD3_N5 row)",
    ),
    GoldenSpec(
        "simple_spread_v3", "HAPPO_1_seed",
        "MAPPO_file/learning_curves/simple_spread_v3/MAPPO_1_seed.npy",
        slack=5.0, floor=-25.0,
        note="N=3 short-protocol guard (ref col is an N=5 run; "
             "protocol-exact gate: HAPPO_N5 row)",
    ),
    GoldenSpec(
        "simple_spread_v3", "MAT_1_seed",
        "MAPPO_file/learning_curves/simple_spread_v3/MAPPO_1_seed.npy",
        slack=8.0, floor=-28.0,
        note="N=3 1500-ep short-protocol guard (protocol-exact gate: "
             "MAT_N5 row)",
    ),
    GoldenSpec(
        "simple_adversary_v3", "IPPO_1_seed", "",
        floor=-22.0,
        note="600-ep short-protocol guard; the reference's committed "
             "IPPO adversary runs are 5000-ep (IPPO_5000 row)",
    ),
    GoldenSpec(
        "simple_spread_v3", "MAAC_1_seed", "",
        floor=-20.0,
        note="N=3 short-protocol guard (ref committed runs are N=5: "
             "MAAC_N5 row)",
    ),
    # ---- PROTOCOL-EXACT N=5 MARL matrix (round 5). The reference's
    # committed simple_spread artifacts are all 5-agent runs
    # (MADDPG_simple.py:214-226 env_agent_n; filename suffix `_N_5`).
    # Each row gates our N=5 CLI run against ALL committed reference
    # runs of that algorithm (ref_paths -> one ref "seed" per run);
    # slack = the reference's own cross-run spread. Off-policy runs use
    # num_envs=8 x updates_per_burst=8 (the reference's 1 update per
    # env step); MASAC/MAAC run at lr 1e-3, the default when the Nov-24
    # N=5 artifacts were produced (MAAC_file/README.md notes the change
    # to 1e-4/5e-4 only on 2025.3.22, for the 40k protocol).
    # Regen: scripts/r5_marl_n5.py [--only TAG].
    GoldenSpec(
        "simple_spread_v3", "MADDPG_N5_3_seed", "",
        ref_paths=tuple(
            f"MADDPG_file/results/simple_spread_v3/MADDPG_{i}/"
            f"MADDPG_seed_{s}_N_5.npy"
            for i, s in ((1, 0), (2, 10), (3, 100))
        ),
        slack=10.7, pending=True,
        note="N=5 600-ep protocol; ref runs -25.4/-25.6/-14.9, slack = "
             "their spread",
    ),
    GoldenSpec(
        "simple_spread_v3", "MATD3_N5_3_seed", "",
        ref_paths=tuple(
            f"MADDPG_file/results/simple_spread_v3/MATD3_simple_{i}/"
            f"MATD3_simple_seed_{s}_N_5.npy"
            for i, s in ((1, 0), (2, 10), (3, 100))
        ),
        slack=4.0, pending=True,
        note="N=5 600-ep protocol; ref runs -16.4/-18.0/-15.3 "
             "(spread 2.7; slack adds one-seed variance headroom)",
    ),
    GoldenSpec(
        "simple_spread_v3", "MASAC_N5_3_seed", "",
        ref_paths=tuple(
            f"MAAC_file/results/simple_spread_v3/MASAC_{i}/"
            f"MASAC_seed_{s}_N_5.npy"
            for i, s in ((1, 0), (2, 10), (3, 100))
        ),
        slack=4.0, pending=True,
        note="N=5 600-ep protocol at the Nov-24 default lr 1e-3; ref "
             "runs -10.4/-11.4/-12.6",
    ),
    GoldenSpec(
        "simple_spread_v3", "MAAC_N5_3_seed", "",
        ref_paths=tuple(
            f"MAAC_file/results/simple_spread_v3/MAAC_discrete_{i}/"
            f"MAAC_discrete_seed_{s}_N_5.npy"
            for i, s in ((1, 0), (2, 10), (3, 100))
        ),
        slack=4.0, pending=True,
        note="N=5 600-ep discrete-actor protocol; ref runs "
             "-16.8/-18.1/-16.0",
    ),
    GoldenSpec(
        "simple_spread_v3", "MADDPG_ATT_N5_3_seed", "",
        ref_paths=tuple(
            f"MADDPG_file/results/simple_spread_v3/MADDPG_simple_ATT_{i}/"
            f"MADDPG_simple_seed_{s}_N_5.npy"
            for i, s in ((1, 0), (2, 10), (3, 100))
        ),
        slack=6.9, pending=True,
        note="N=5 600-ep ATT-critic protocol; ref runs "
             "-19.6/-18.0/-12.7, slack = their spread",
    ),
    GoldenSpec(
        "simple_spread_v3", "MAPPO_N5_3_seed", "",
        ref_paths=tuple(
            f"MAPPO_file/results/simple_spread_v3/MAPPO_{i}/"
            f"MAPPO_seed_{s}_N_5.npy"
            for i, s in ((1, 0), (2, 10), (3, 100))
        ),
        slack=4.0,
        note="N=5 5000-ep protocol; ref runs -10.8/-9.4/-8.2 (spread "
             "2.6 + headroom). Our seeds -12.6/-17.8/-9.6: layout 10 "
             "is the drag — two independent redraws on it land "
             "-14.3/-13.0 (results/r5_mappo_l10.log), i.e. a harder "
             "layout plus a below-typical first draw, not a "
             "systematic MAPPO deficit",
    ),
    GoldenSpec(
        "simple_spread_v3", "MAPPO_attention_N5_3_seed", "",
        ref_paths=tuple(
            f"MAPPO_file/results/simple_spread_v3/MAPPO_attention_{i}/"
            f"MAPPO_attention_seed_{s}_N_5.npy"
            for i, s in ((1, 0), (2, 10), (3, 100))
        ),
        slack=4.0, pending=True,
        note="N=5 5000-ep attention-critic protocol; ref runs "
             "-10.6/-9.2/-8.0",
    ),
    GoldenSpec(
        "simple_spread_v3", "HAPPO_N5_3_seed", "",
        ref_paths=tuple(
            f"MAPPO_file/results/simple_spread_v3/HAPPO_{i}/"
            f"HAPPO_seed_{s}_N_5.npy"
            for i, s in ((1, 0), (2, 10), (3, 100))
        ),
        slack=6.3, pending=True,
        note="N=5 5000-ep protocol; ref runs -10.7/-14.2/-7.9, slack = "
             "their spread",
    ),
    GoldenSpec(
        "simple_spread_v3", "MAT_N5_3_seed", "",
        ref_paths=tuple(
            f"MAPPO_file/results/simple_spread_v3/MAT_{i}/"
            f"MAT_seed_{s}_N_5.npy"
            for i, s in ((1, 0), (2, 10), (3, 100))
        ),
        slack=6.2, pending=True,
        note="N=5 7000-ep protocol; ref runs -11.2/-14.4/-8.3, slack = "
             "their spread",
    ),
    GoldenSpec(
        # protocol-exact twin of the reference's committed evidence: its
        # two IPPO adversary runs are BOTH layout seed 100 (IPPO_1 and
        # IPPO_2 each carry IPPO_seed_100.npy — two independent draws on
        # ONE fixed layout). Ours: seeds 100/1100 with --reset_seed 100.
        "simple_adversary_v3", "IPPO_L100_4_seed", "",
        ref_paths=(
            "MAPPO_file/results/simple_adversary_v3/IPPO_1/"
            "IPPO_seed_100.npy",
            "MAPPO_file/results/simple_adversary_v3/IPPO_2/"
            "IPPO_seed_100.npy",
        ),
        slack=2.4, overlap_gate=False,
        note="5000-ep adversary, layout 100 (both ref runs' layout); "
             "ref draws +4.1/+1.7 (spread 2.4 = the slack). Our four "
             "independent draws cluster at +1.37/+1.39/+1.46/+1.52 — a "
             "stable equilibrium 0.2 under the ref's lower draw; "
             "mixed-competitive self-play converges to an "
             "implementation-specific adversary-vs-good equilibrium, "
             "so the cross-draw overlap gate is off (documented) and "
             "the mean gate carries the comparison",
    ),
    GoldenSpec(
        # cross-LAYOUT spread record (no reference counterpart — its
        # committed runs never vary the layout): 3 layouts, floor guards
        # learning on every one. Layout difficulty genuinely varies
        # (mixed-competitive returns are layout-dependent).
        "simple_adversary_v3", "IPPO_5000_3_seed", "",
        floor=-3.0, pending=True,
        note="3-layout spread record (-1.7/+0.9/+1.3); the reference "
             "has no multi-layout evidence, floor guards learning",
    ),
    GoldenSpec(
        "simple_spread_v3", "MAPPO_attention_N30_1_seed", "",
        ref_paths=(
            "MAPPO_file/results/simple_spread_v3/MAPPO_attention_4/"
            "MAPPO_attention_seed_0_N_30.npy",
        ),
        slack=10.0, pending=True,
        note="N=30 5000-ep — the reference's one large-agent-count "
             "artifact (-78.4); slack ~= the N=5 family's cross-run "
             "spread scaled by the 6x reward magnitude",
    ),
    # ---- round-5 single-agent protocol-exact rows (fixed reset, the
    # reference's own per-episode env.reset(seed) convention; regen:
    # scripts/r5_singles.py). ref_paths = the committed per-run curves.
    GoldenSpec(
        "CartPole-v1", "PPO_3_seed", "",
        ref_paths=tuple(
            f"PPO_file/results/CartPole-v1/PPO_{i}/PPO_seed_{s}.npy"
            for i, s in ((1, 0), (2, 10), (3, 100))
        ),
        slack=25.0, pending=True,
        note="ref runs 500/500/500 (saturated); slack = 5% of scale",
    ),
    GoldenSpec(
        "Pendulum-v1", "PPO_3_seed", "",
        ref_paths=tuple(
            f"PPO_file/results/Pendulum-v1/PPO_{i}/PPO_seed_{s}.npy"
            for i, s in ((1, 0), (2, 10), (3, 100))
        ),
        slack=95.8, pending=True,
        note="ref runs -126.1/-317.8/-228.6 (mean -224.2), slack = "
             "their spread/2",
    ),
    GoldenSpec(
        "LunarLander-v2", "PPO_3_seed", "",
        ref_paths=(
            "PPO_file/results/LunarLander-v2/PPO_1/PPO_seed_100.npy",
        ),
        slack=60.0, pending=True,
        note="one committed ref run (+220.2, seed 100); slack spans "
             "typical PPO-LL seed variance, floor-guarded by overlap",
    ),
    GoldenSpec(
        "BipedalWalker-v3", "PPO_10_seed", "",
        ref_paths=tuple(
            f"PPO_file/results/BipedalWalker-v3/PPO_{i}/PPO_seed_{s}.npy"
            for i, s in ((1, 0), (2, 10), (3, 100))
        ),
        slack=45.5, agg="best",
        note="convergence lottery, documented: 10 draws over fixed "
             "layouts land -0.3..+231.3 with THREE in the reference "
             "band (+180.8/+191.2/+231.3 vs its +169.8/+201.3/+260.7; "
             "the ref's own three runs span 90 points), and draws "
             "reach per-episode maxima +261..+294 (= its best "
             "episodes, validating the physics port at reference-level "
             "returns). Best-draw gate; the ~90-plateau typical draw "
             "remains a KNOWN gap (ROADMAP)",
    ),
    GoldenSpec(
        "Pendulum-v1", "SAC_1_seed", "",
        ref_paths=("SAC_file/results/Pendulum-v1/SAC_10/SAC_seed_0.npy",),
        slack=15.0, pending=True,
        note="ref -125.2 (its other committed run -125.9)",
    ),
    GoldenSpec(
        "Pendulum-v1", "TD3_1_seed", "",
        ref_paths=("TD3_file/results/Pendulum-v1/TD3_1/TD3_seed_0.npy",),
        slack=15.0, pending=True, note="ref -127.3",
    ),
    GoldenSpec(
        "Pendulum-v1", "DDPG_simple_3_seed", "",
        ref_paths=tuple(
            f"DDPG_file/results/Pendulum-v1/DDPG_simple_{i}/"
            f"DDPG_simple_seed_{s}.npy"
            for i, s in ((1, 0), (2, 10), (3, 100))
        ),
        slack=60.7, pending=True,
        note="ref runs -127.9/-249.4/-130.2 (mean -169.1; seed-10 is "
             "its own bad draw), slack = their spread/2",
    ),
    GoldenSpec(
        "CartPole-v1", "SAC_discrete_1_seed", "",
        ref_paths=(
            "SAC_file/results/CartPole-v1/SAC_add_discrete_1/"
            "SAC_add_discrete_seed_0.npy",
        ),
        slack=50.0, pending=True, note="ref 500.0 (saturated)",
    ),
    GoldenSpec(
        "CartPole-v1", "DDPG_discrete_3_seed", "",
        ref_paths=tuple(
            f"DDPG_file/results/CartPole-v1/DDPG_simple_add_discrete_{i}/"
            f"DDPG_simple_add_discrete_seed_0.npy"
            for i in (1, 2, 3)
        ),
        slack=100.0,
        note="draw-for-draw twin of the reference's protocol: its three "
             "same-seed runs span 82.4/462.2/457.4, our three draws on "
             "the same layout span 107.6/205.9/451.5 (best 451.5 ~= "
             "its best 462.2)",
    ),
    GoldenSpec(
        "FrozenLake-v1", "DQN_10_seed", "",
        ref_paths=tuple(
            f"DQN_file/results/FrozenLake-v1/DQN_{i}/DQN_seed_{s}.npy"
            for i, s in ((1, 0), (2, 10), (3, 100))
        ),
        slack=0.08, agg="best",
        note="KNOWN behavioral gap, documented: the reference's code "
             "rerun HERE reproduces 0.16-0.24 while our 10-seed sweep "
             "spans 0.00-0.14 (training-time policy oscillates; the "
             "final greedy policy reaches 0.19-0.20 success, measured "
             "vs the 0.75 tabular optimum). Best-seed gate (0.14 vs "
             "ref min 0.12) + this note keep the deficit visible; "
             "evidence results/reference_rerun/ref_dqn_rerun.log",
    ),
    GoldenSpec(
        "Taxi-v3", "DQN_1_seed", "",
        ref_paths=("DQN_file/results/Taxi-v3/DQN_3/DQN_seed_100.npy",),
        slack=80.0, pending=True,
        note="ref -266.6 (seed 100, its one committed run)",
    ),
    GoldenSpec(
        # CEM-GD3PG BipedalWalker: the reference's two committed runs of
        # the IDENTICAL config span -110.5 (CEM_GD3PG_7) to +189.5
        # (CEM_GD3PG_8) — a high-variance algorithm. Gate mirrors the
        # ENVELOPE-sweep precedent: slack = the reference's own
        # across-run spread, floor = its worse committed run. Our
        # artifact stacks two independent draws (scripts/r5_cem_bipedal).
        "BipedalWalker-v3", "CEM_GD3PG_4_seed", "",
        ref_paths=(
            "CEM_GD3PG_file/results/BipedalWalker-v3/CEM_GD3PG_7/"
            "CEM_GD3PG_seed_0.npy",
            "CEM_GD3PG_file/results/BipedalWalker-v3/CEM_GD3PG_8/"
            "CEM_GD3PG_seed_0.npy",
        ),
        slack=300.0, floor=-110.5, agg="best",
        note="ref's two same-config runs: -110.5 / +189.5 (spread 300); "
             "our four draws: +81.9 / +143.2 / +13.5 / +74.5 — ALL walk (the "
             "ref's worse one crashes), best 46 under its best with "
             "last-25 still climbing (+168) at the 500-ep cutoff. "
             "Best-draw gate + floor at its worse run; regen "
             "scripts/r5_cem_bipedal.py",
    ),
    GoldenSpec(
        # north-star conjunction (BASELINE.md): a full LunarLander DQN
        # training run at a >=1M env-steps/s operating point whose
        # final-1000 return reaches the reference's 3-seed final-50 mean
        # (123). scripts/r5_northstar.py sweeps operating points and
        # saves the fastest parity point's tail curve.
        "LunarLander-v2", "DQN_fast_1_seed",
        "DQN_file/learning_curves/LunarLander-v2/DQN_3_seed.npy",
        slack=0.0, pending=True,
        note="parity AT >=1M env-steps/s (results/northstar.json "
             "records the measured steady-state rate)",
    ),
    # ---- ENVELOPE MORL (reference ENVELOPE_MORL_file committed run):
    # training curve + the eval_agent.py 100-preference sweep
    # (scripts/envelope_e2e.py reproduces both artifacts).
    GoldenSpec(
        "deep-sea-treasure-v0", "ENVELOPE_1_seed",
        "ENVELOPE_MORL_file/results/deep-sea-treasure-v0/ENVELOPE_DQN_1/"
        "ENVELOPE_seed_0.npy",
        slack=2.0,
        note="5000-ep DST protocol (ENVELOPE_DQN.py:388-416 defaults), "
             "protocol-exact num_envs=1 run: ours +2.59 vs ref +2.3; "
             "regen: scripts/envelope_seed_sweep.sh + envelope_finalize",
    ),
    # ---- beyond-curve empirical claims README/PARITY cite, now gated
    GoldenSpec(
        # pixel pipeline (PPO_file/PPO_with_pixel capability): DQN on
        # pixel CartPole through envs/pixel.py + nets/cnn.py. No
        # reference curve (its pixel run is a PPO notebook); floor is
        # just under the measured 39.7 -> 42.9 curve so a silent
        # regression to the untrained ~10 return fails loudly.
        "PixelCartPole-v1", "DQN_seed_0", "",
        floor=35.0,
        note="pixel pipeline e2e (scripts/pixel_curve.py); starts ~9.8",
    ),
    GoldenSpec(
        # 8-device sharded DP driver curve (distributed/dp.py): CartPole
        # DQN on the 8-way CPU mesh. Floor guards the sharded learner
        # actually learning, not just compiling (scripts/dp_scaling.py).
        "CartPole-v1", "DQN_dp8_1_seed", "",
        window=30, floor=100.0,
        note="train_offpolicy_sharded on 8-device mesh (dp_scaling.py)",
    ),
    GoldenSpec(
        # 8-device sharded MARL driver curve (train_marl_sharded):
        # MADDPG spread on the 8-way CPU mesh, gated against the
        # reference's own MADDPG curve like the single-device row
        # (scripts/dp_scaling.py regenerates).
        "simple_spread_v3", "MADDPG_dp8_1_seed",
        "MADDPG_file/learning_curves/simple_spread_v3/MADDPG_1_seed.npy",
        slack=5.0, floor=-25.0,
        note="train_marl_sharded on 8-device mesh (dp_scaling.py)",
    ),
    GoldenSpec(
        # recurrent MAPPO (GRU + truncated BPTT — beyond-reference: the
        # reference lists rmappo as unimplemented). Family-gated vs the
        # reference's MAPPO spread curve like HAPPO/MAT.
        "simple_spread_v3", "RMAPPO_1_seed",
        "MAPPO_file/learning_curves/simple_spread_v3/MAPPO_1_seed.npy",
        slack=8.0, floor=-28.0, pending=True,
        note="no reference rmappo; gated vs its MAPPO family run "
             "(scripts/marl_curves.py --only RMAPPO)",
    ),
    GoldenSpec(
        "deep-sea-treasure-v0", "ENVELOPE_sweep_1_seed",
        "ENVELOPE_MORL_file/results/deep-sea-treasure-v0/ENVELOPE_DQN_1/"
        "reward.npy",
        # The reference's OWN committed runs span sweep means -2.81
        # (ENVELOPE_DQN_2, labeled "training not good" in
        # eval_agent.py:24: the high-treasure band w1~0.72-0.98 fails by
        # truncation, 28/100 weights) to +6.52 (ENVELOPE_DQN_1, the tail
        # outcome where that band annealed). Our protocol-exact runs
        # reproduce the same characteristic band (24/100 failed weights;
        # every other weight matches the reference's Pareto values to
        # the cent — results/envelope_runs_summary.json). Gate: slack =
        # the reference's own across-run spread (9.4), floor = its worse
        # committed run; a tail draw tightens this naturally.
        # Matmul precision matters for the annealing endgame: the top
        # FOUR of 22 protocol-exact draws are all f32-matmul runs
        # (+6.26 / +4.36 / +3.50 / +2.63) while every default-bf16 draw
        # lands <= -1.3 — bf16 noise feeds the max-bias inflation loop
        # at extreme preferences, so the CLI forces f32 matmuls for
        # ENVELOPE. The promoted best (+6.26, precision 0.93, recall
        # 0.91, AE 2.0, 1/100 failed weights) matches the reference's
        # own best committed run (+6.52, its annealed tail).
        window=100, slack=9.4, floor=-2.81,
        note="100-pref Pareto sweep (eval_agent.py:42-101); ref runs "
             "span -2.81..+6.52, slack = that spread, floor = ref's "
             "worse run; best ours +6.26 ~= ref best +6.52; evidence "
             "results/envelope_runs_summary.json",
    ),
]


def _per_seed_final(path: str, window: int) -> Optional[np.ndarray]:
    # floor-only specs carry ref_path="" (no reference curve exists)
    if not path or not os.path.isfile(path):
        return None
    arr = np.load(path)
    if arr.ndim == 1:
        arr = arr[None]
    w = min(window, arr.shape[1])
    return arr[:, -w:].mean(axis=1)


def check(spec: GoldenSpec, ref_root: Optional[str] = None) -> dict:
    """Two-part acceptance, both required:

    1. mean gate — our mean final-window return >= the reference's minus
       ``slack`` (one-sided; beating the reference always satisfies it);
    2. seed-overlap gate — our BEST seed >= the reference's WORST seed.
       Final-window returns are bimodal on several envs (catastrophic
       forgetting), so hand slacks must be wide; this distribution-aware
       check closes the hole a wide slack opens: a uniformly-collapsed
       run (e.g. every seed flat at 22 vs a reference worst seed of 213)
       fails (2) no matter the slack, while genuine seed variance whose
       support overlaps the reference's passes.

    The reference curves are read under ``ref_root`` (default
    ``REF_ROOT``).
    """
    ref_root = REF_ROOT if ref_root is None else ref_root
    ours_path = os.path.join(OURS_ROOT, spec.env, spec.algo + ".npy")
    ours_seeds = _per_seed_final(ours_path, spec.window)
    if spec.ref_paths:
        vals = []
        for rel in spec.ref_paths:
            p = os.path.join(ref_root, rel)
            if os.path.isfile(p):
                arr = np.load(p)
                if arr.ndim == 1:
                    arr = arr[None]
                # (n_agents, episodes): final-window mean over agents ==
                # the run's final-50 per-agent-mean return
                vals.append(float(arr[:, -spec.window:].mean()))
        ref_seeds = np.asarray(vals) if vals else None
    else:
        ref_path = os.path.join(ref_root, spec.ref_path)
        ref_seeds = _per_seed_final(ref_path, spec.window)
    stat = (lambda a: float(a.max())) if spec.agg == "best" else (
        lambda a: float(a.mean())
    )
    ours = None if ours_seeds is None else stat(ours_seeds)
    ref = None if ref_seeds is None else stat(ref_seeds)
    status = "missing"
    overlap = None
    floor_ok = (spec.floor is None or
                (ours is not None and ours >= spec.floor))
    if ours is not None and ref is not None:
        if spec.slack_mode == "dist":
            assert ref_seeds.size >= 2, (
                f"{spec.env}/{spec.algo}: 'dist' slack mode needs a "
                f"multi-seed reference artifact"
            )
            ref_std = float(ref_seeds.std(ddof=0))
            mean_ok = (ours >= ref - ref_std
                       or float(ours_seeds.max()) >= ref)
        else:
            mean_ok = ours >= ref - spec.slack
        # the distribution check needs a distribution: with a single
        # committed reference seed best-vs-worst degenerates to an
        # ours>=ref equality gate stricter than any slack, so it applies
        # only to multi-seed artifacts on both sides
        if ref_seeds.size >= 2 and ours_seeds.size >= 2 \
                and spec.overlap_gate:
            overlap = bool(ours_seeds.max() >= ref_seeds.min())
        else:
            overlap = True
        status = "pass" if (mean_ok and overlap and floor_ok) else "FAIL"
    elif ours is not None and ref is None and spec.floor is not None:
        # floor-only spec (no reference curve exists for this algorithm)
        status = "pass" if floor_ok else "FAIL"
    elif ref is None and spec.floor is None:
        status = "no-reference"
    # ours missing while a reference curve or floor exists -> 'missing'
    if status == "missing" and spec.pending:
        status = "pending"
    return {
        "env": spec.env, "algo": spec.algo, "ours": ours, "ref": ref,
        "slack": spec.slack, "status": status, "note": spec.note,
        "ours_seeds": None if ours_seeds is None else
        [round(float(x), 1) for x in ours_seeds],
        "ref_seeds": None if ref_seeds is None else
        [round(float(x), 1) for x in ref_seeds],
        "seed_overlap": overlap,
    }


# ---------------------------------------------------------------------------
# scalar gates: empirical claims whose artifact is a summary metric, not a
# learning curve (the GAIL imitation result lives in an eval summary.json)
# ---------------------------------------------------------------------------
SCALAR_GATES = [
    {
        # GAIL Pendulum imitation parity (GAIL_file/GAIL.py protocol):
        # the newest results/gail summary must keep gail_eval_avg above
        # the floor (just under the committed -185.1) and the reference's
        # own best run (-184.1) minus slack. Regen: scripts/gail_e2e.py.
        "name": "GAIL_Pendulum_eval",
        "glob": "results/gail/Pendulum-v1/GAIL/*/summary.json",
        "key": "gail_eval_avg",
        "floor": -190.0,
        "ref": -184.1,
        "slack": 6.0,
        "note": "imitation eval avg (committed -185.1 vs ref best -184.1)",
    },
]


def check_scalar(gate: dict, root: Optional[str] = None) -> dict:
    """The gate's row from the newest summary its ``results/...`` glob
    finds under ``root`` (the port's results tree, the parent of
    ``OURS_ROOT``, by default)."""
    import glob
    import json

    if root is None:
        root = os.path.dirname(os.path.normpath(OURS_ROOT))
    rel = gate["glob"].removeprefix("results/")
    paths = sorted(glob.glob(os.path.join(root, rel)))
    ours = None
    if paths:
        with open(paths[-1]) as f:
            ours = float(json.load(f)[gate["key"]])
    status = "missing"
    if ours is not None:
        ok = ours >= gate["floor"] and ours >= gate["ref"] - gate["slack"]
        status = "pass" if ok else "FAIL"
    return {
        "env": gate["name"], "algo": gate["key"], "ours": ours,
        "ref": gate["ref"], "slack": gate["slack"], "status": status,
        "note": gate["note"], "ours_seeds": None, "ref_seeds": None,
        "seed_overlap": None,
    }


def check_all(specs: Optional[List[GoldenSpec]] = None) -> List[dict]:
    rows = [check(s) for s in (specs or SPECS)]
    if specs is None:
        rows += [check_scalar(g) for g in SCALAR_GATES]
    return rows


# ---------------------------------------------------------------------------
# parity with the JAX package: the port's curve of a stem held against the
# JAX package's committed curve of the same stem, or against the JAX
# package's curve of the same recipe rerun at this commit. Torch's Philox
# and JAX's threefry streams never agree, so the parity is statistical:
# ``check``'s rule (mean gate with ``slack``, seed overlap, ``agg``,
# ``slack_mode``, ``floor``) with the JAX curve as the reference.
# ---------------------------------------------------------------------------
JAX_CURVES_ROOT = os.path.join(os.path.dirname(__file__), "..", "..",
                               "results", "learning_curves")
# the JAX package rerun at this commit on the CPU (scripts/torch_jax_head.py):
# a reference from today's JAX code for rows whose committed JAX curve dates
# from an older commit; each env directory's provenance.json says how
JAX_HEAD_ROOT = os.path.join(os.path.dirname(__file__), "..", "..",
                             "results", "torch", "jax_head")


@dataclasses.dataclass(frozen=True)
class ParityRow(GoldenSpec):
    # the tree of JAX curves the row is held against: 'committed' (the JAX
    # package's results/learning_curves/) or 'jax_head' (JAX_HEAD_ROOT)
    ref: str = "committed"
    # how the seeds are stacked: smoothed (alpha 0.9) as ``regenerate``
    # stacks them, or raw and cut to the shortest, as scripts/r5_singles.py
    smooth: bool = True
    # with ``smooth`` off, the bins each raw curve is averaged into before
    # it is stacked (``bin_curve``, as scripts/train_spread.py's curve was
    # cut to 600 points); 0 for none
    bins: int = 0
    # each seed's run is swept over the 100 preferences right after it
    # trains (scripts/torch_envelope_e2e.py; the JAX side by
    # scripts/envelope_e2e.sweep), one run feeding every row of its recipe
    then_sweep: bool = False
    # the file of a seed's run dir that holds its curve, where it is not
    # the CLI's ``<ALGO>_seed_<s>.npy`` (the sweep's ``reward.npy``)
    curve_file: str = ""
    # the JAX package's script a seed of the row runs, where its recipe is
    # no CLI argv (``pixel_curve``: scripts/pixel_curve.py); ``regen`` is
    # then that script's argv, and the port runs scripts/torch_<script>.py
    script: str = ""
    # 'seeds': the row is held by ``seed_rule`` over the seeds both sides
    # keep, in place of ``check``'s gate
    rule: str = ""


def parity_row(spec: GoldenSpec, **changes) -> ParityRow:
    """``spec`` as a :class:`ParityRow`, with ``changes`` applied."""
    return dataclasses.replace(ParityRow(*dataclasses.astuple(spec)),
                               **changes)


def row_key(row: GoldenSpec) -> str:
    """``ENV/STEM``, and ``@REF`` for a row held against another tree than
    the committed JAX curves."""
    ref = getattr(row, "ref", "committed")
    key = f"{row.env}/{row.algo}"
    return key if ref == "committed" else f"{key}@{ref}"


def ref_root(row: GoldenSpec) -> str:
    """The root of the JAX curves ``row`` is held against."""
    return {"committed": JAX_CURVES_ROOT,
            "jax_head": JAX_HEAD_ROOT}[getattr(row, "ref", "committed")]


def spec_of(env: str, stem: str) -> GoldenSpec:
    """The row of ``SPECS`` with this env and stem."""
    return next(s for s in SPECS if (s.env, s.algo) == (env, stem))


# the golden DQN recipe's seeds for a spread on both sides: SPECS[0]'s three,
# then 1-14 but 10 (16 distinct seeds)
DQN_LL_SEEDS16 = (0, 10, 100) + tuple(s for s in range(1, 15) if s != 10)
# ... and 32 more, 15-46, for the 48-seed spread (ROADMAP C9)
DQN_LL_SEEDS48 = DQN_LL_SEEDS16 + tuple(range(15, 47))
# ... and 48 more, 47-94, for the 96-seed spread (ROADMAP C16)
DQN_LL_SEEDS96 = DQN_LL_SEEDS48 + tuple(range(47, 95))

# scripts/r5_singles.py's table (its lines 36-59), the reference-committed
# configs of round 5: tag -> (algo, env, artifact stem, seeds, extra argv).
# Every run takes 500 episodes, 8 envs and --fixed_reset; off-policy runs
# take 8 envs x updates_per_burst 8 (1 update per env step)
_UPB = ["--updates_per_burst", "8"]
_R5_DQN = ["--batch_size", "256", "--buffer_size", "1000000",
           "--start_steps", "500"] + _UPB
R5_RUNS = {
    "PPO_CartPole": ("PPO", "CartPole-v1", "PPO", (0, 10, 100),
                     ["--horizon", "2048"]),
    "PPO_Pendulum": ("PPO", "Pendulum-v1", "PPO", (0, 10, 100),
                     ["--horizon", "2048"]),
    "PPO_LunarLander": ("PPO", "LunarLander-v2", "PPO", (0, 10, 100),
                        ["--horizon", "2048"]),
    "PPO_BipedalWalker": ("PPO", "BipedalWalker-v3", "PPO", (0, 10, 100),
                          ["--horizon", "2048"]),
    "SAC_Pendulum": ("SAC", "Pendulum-v1", "SAC", (0,),
                     ["--batch_size", "256", "--random_steps", "500"]
                     + _UPB),
    "TD3_Pendulum": ("TD3", "Pendulum-v1", "TD3", (0,),
                     ["--batch_size", "256"] + _UPB),
    "DDPG_Pendulum": ("DDPG", "Pendulum-v1", "DDPG_simple", (0, 10, 100),
                      ["--batch_size", "256"] + _UPB),
    "DDPG_discrete_CartPole": ("DDPG", "CartPole-v1", "DDPG_discrete",
                               (0,), ["--batch_size", "256"] + _UPB),
    "SAC_discrete_CartPole": ("SAC", "CartPole-v1", "SAC_discrete", (0,),
                              ["--batch_size", "256",
                               "--random_steps", "500"] + _UPB),
    "DQN_FrozenLake": ("DQN", "FrozenLake-v1", "DQN", (0, 10, 100), _R5_DQN),
    "DQN_Taxi": ("DQN", "Taxi-v3", "DQN", (100,), _R5_DQN),
}
# tags whose rows wait for the port (none since the walker's step and reset
# run as kernels on the card, ``ops/bipedal.py``)
R5_LATER = ()
# the tag of R5_RUNS that trains on the walker: chip_smoke.py's
# ``ppo_bipedal_recipe`` runs it
R5_WALKER = ("PPO_BipedalWalker",)


def r5_argv(tag: str, seed, num_envs: int = 8,
            results_root: Optional[str] = None) -> list:
    """The CLI argv scripts/r5_singles.py passes for one seed of ``tag``
    (without ``--results_root`` and ``--no_tensorboard`` where
    ``results_root`` is None)."""
    algo, env_name, _, _, extra = R5_RUNS[tag]
    out = ["--algo", algo, "--env_name", env_name, "--max_episodes", "500",
           "--num_envs", str(num_envs), "--seed", str(seed), "--fixed_reset"]
    if results_root is not None:
        out += ["--results_root", results_root, "--no_tensorboard"]
    return out + list(extra)


# the JAX SPECS row whose gate a tag's rows take, where its stem is not the
# one the JAX script writes: DDPG_discrete's gate is on the 3-draw stem,
# FrozenLake's on the 10-seed sweep, the walker's on the 10 draws of the
# same recipe (SPECS has no BipedalWalker PPO_3_seed row)
_R5_GATE_STEM = {"DDPG_discrete_CartPole": "DDPG_discrete_3_seed",
                 "DQN_FrozenLake": "DQN_10_seed",
                 "PPO_BipedalWalker": "PPO_10_seed"}


def r5_rows(tag: str) -> List[ParityRow]:
    """The tag's two rows, against the JAX package's committed stack and
    against JAX at this commit: the gate fields (window, slack, agg, mode,
    overlap, floor) of the JAX SPECS row of its stem, the stem the JAX
    script writes, its argv and seeds."""
    algo, env_name, stem, seeds, _ = R5_RUNS[tag]
    ours = f"{stem}_{len(seeds)}_seed"
    gate = _R5_GATE_STEM.get(tag, ours)
    spec = spec_of(env_name, gate)
    note = f"r5 {tag}; JAX SPECS gate of {env_name}/{gate}"
    if gate != ours:
        note += f", held against the {ours} stack scripts/r5_singles.py " \
                f"writes"
    return [parity_row(spec, algo=ours, ref_path=f"{env_name}/{ours}.npy",
                       ref_paths=(), pending=False, note=note,
                       regen=tuple(r5_argv(tag, "{seed}")),
                       regen_seeds=seeds, ref=ref, smooth=False)
            for ref in ("committed", "jax_head")]


# the MountainCar DQN trick matrix of SPECS (README.md's compare chart), in
# the order its card runs are queued, longest first
MC_TRICKS = ("Noisy", "Rainbow", "Categorical", "PER", "N_Step", "Double",
             "Dueling")


def mountaincar_rows() -> List[ParityRow]:
    """The trick matrix's rows: each trick's SPECS row (its recipe, seeds,
    window, slack and aggregate; stacked smoothed, as ``regenerate``
    stacks it) against the JAX package's committed stack of its stem and
    against JAX at this commit; and the base row's recipe over its 3 seeds
    as ``DQN_fixedreset_3_seed`` against JAX at this commit only (the
    committed ``DQN_fixedreset_13_seed`` is a best of 13 seeds, and a
    best-seed gate compares only samples of one size)."""
    rows = []
    for t in MC_TRICKS:
        stem = f"DQN_{t}_{10 if t == 'Noisy' else 3}_seed"
        spec = spec_of("MountainCar-v0", stem)
        rows += [parity_row(spec, ref_path=f"MountainCar-v0/{stem}.npy",
                            ref=ref, note=f"SPECS MountainCar-v0/{stem}")
                 for ref in ("committed", "jax_head")]
    base = spec_of("MountainCar-v0", "DQN_fixedreset_13_seed")
    return rows + [parity_row(
        base, algo="DQN_fixedreset_3_seed",
        ref_path="MountainCar-v0/DQN_fixedreset_3_seed.npy", ref="jax_head",
        note="SPECS MountainCar-v0/DQN_fixedreset_13_seed's recipe and "
             "gate over its 3 seeds")]


# the SPECS rows with a recipe that no other function here holds, by env and
# stem, in the order their card runs are queued, longest first
A2_STEMS = (("MountainCarContinuous-v0", "DDPG_OUNoise_3_seed"),
            ("MountainCarContinuous-v0", "DDPG_simple_1_seed"),
            ("CartPole-v1", "REINFORCE_3_seed"),
            ("CartPole-v1", "DQN_3_seed"),
            ("Pendulum-v1", "DQN_3_seed"),
            ("MountainCarContinuous-v0", "PPO_ObsNorm_3_seed"))
# the A2 stems whose recipe is also a row over ``DQN_LL_SEEDS16`` against JAX
# at this commit, for ROADMAP queue C's rule for seeds (C14-C17)
SEEDS16_STEMS = (("Pendulum-v1", "DQN_3_seed"),
                 ("CartPole-v1", "REINFORCE_3_seed"),
                 ("MountainCarContinuous-v0", "PPO_ObsNorm_3_seed"),
                 ("MountainCarContinuous-v0", "DDPG_OUNoise_3_seed"))


def a2_rows() -> List[ParityRow]:
    """Each of ``A2_STEMS``' SPECS rows (its recipe, seeds, window, slack,
    aggregate, slack mode and floor; stacked smoothed, as ``regenerate``
    stacks it) against the JAX package's committed stack of its own stem
    and against JAX at this commit. Both DDPG rows of SPECS take the
    reference's ``DDPG_simple_1_seed`` curve; here ``DDPG_OUNoise_3_seed``
    is held against the JAX package's own stack of that stem."""
    rows = []
    for env, stem in A2_STEMS:
        spec = spec_of(env, stem)
        note = f"SPECS {env}/{stem}"
        if spec.ref_path.rsplit("/", 1)[-1] != f"{stem}.npy":
            note += (f", held against the JAX package's {stem} stack (SPECS "
                     f"takes the reference's {spec.ref_path})")
        rows += [parity_row(spec, ref_path=f"{env}/{stem}.npy", ref=ref,
                            note=note)
                 for ref in ("committed", "jax_head")]
    return rows


# scripts/marl_curves.py's table (its lines 24-34): algo -> (env, episodes,
# extra argv); each run takes 8 envs and seed 0
MARL_RUNS = {
    "MATD3": ("simple_spread_v3", 600, []),
    "HAPPO": ("simple_spread_v3", 600, []),
    "MAT": ("simple_spread_v3", 1500, []),
    "IPPO": ("simple_adversary_v3", 600, []),
    "MAAC": ("simple_spread_v3", 2000, []),
    "RMAPPO": ("simple_spread_v3", 600, []),
}
# the slack of the rows whose SPECS row has a floor and no reference curve:
# IPPO takes SPECS' slack for IPPO on its env (IPPO_L100_4_seed, the
# reference's own draw spread), MAAC the slack SPECS gives every other N=3
# simple_spread_v3 row of the 600-episode protocol
MARL_SLACK = {"IPPO": 2.4, "MAAC": 5.0}


def marl_argv(algo: str, seed, results_root: Optional[str] = None) -> list:
    """The CLI argv scripts/marl_curves.py passes for one seed of ``algo``
    (without ``--results_root`` and ``--no_tensorboard`` where
    ``results_root`` is None)."""
    env_name, episodes, extra = MARL_RUNS[algo]
    out = ["--algo", algo, "--env_name", env_name, "--max_episodes",
           str(episodes), "--num_envs", "8", "--seed", str(seed)]
    if results_root is not None:
        out += ["--results_root", results_root, "--no_tensorboard"]
    return out + list(extra)


def marl_rows(algo: str) -> List[ParityRow]:
    """The algo's two rows, ``<env>/<ALGO>_1_seed`` over seed 0, against
    the JAX package's committed curve (scripts/marl_curves.py's output) and
    against JAX at this commit: the gate fields of the SPECS row of the
    stem, with ``MARL_SLACK`` where that row has no reference curve, and
    stacked raw, as the JAX script copies its run's curve."""
    env_name = MARL_RUNS[algo][0]
    stem = f"{algo}_1_seed"
    spec = spec_of(env_name, stem)
    note = f"marl_curves {algo}; JAX SPECS gate of {env_name}/{stem}"
    if algo in MARL_SLACK:
        note += f" with slack {MARL_SLACK[algo]}"
    return [parity_row(spec, ref_path=f"{env_name}/{stem}.npy",
                       slack=MARL_SLACK.get(algo, spec.slack),
                       pending=False, note=note,
                       regen=tuple(marl_argv(algo, "{seed}")),
                       regen_seeds=(0,), ref=ref, smooth=False)
            for ref in ("committed", "jax_head")]


# scripts/r5_marl_n5.py's table (its lines 43-73), the reference's N=5
# protocol: tag -> (algo, env, episodes, extra argv); off-policy runs take
# 8 envs x updates_per_burst 8 (1 update per env step)
N5_RUNS = {
    "MADDPG_N5": ("MADDPG", "simple_spread_v3", 600, ["--N", "5"] + _UPB),
    "MATD3_N5": ("MATD3", "simple_spread_v3", 600, ["--N", "5"] + _UPB),
    "MASAC_N5": ("MASAC", "simple_spread_v3", 600,
                 ["--N", "5", "--actor_lr", "1e-3", "--critic_lr", "1e-3"]
                 + _UPB),
    "MAAC_N5": ("MAAC", "simple_spread_v3", 600,
                ["--N", "5", "--actor_lr", "1e-3", "--critic_lr", "1e-3"]
                + _UPB),
    "MADDPG_ATT_N5": ("MADDPG", "simple_spread_v3", 600,
                      ["--N", "5", "--trick", "ATT"] + _UPB),
    "MAPPO_N5": ("MAPPO", "simple_spread_v3", 5000, ["--N", "5"]),
    "MAPPO_attention_N5": ("MAPPO", "simple_spread_v3", 5000,
                           ["--N", "5", "--trick", "attention"]),
    "HAPPO_N5": ("HAPPO", "simple_spread_v3", 5000, ["--N", "5"]),
    "MAT_N5": ("MAT", "simple_spread_v3", 7000,
               ["--N", "5", "--discrete_actions", "--horizon", "256"]),
    "IPPO_5000": ("IPPO", "simple_adversary_v3", 5000, []),
    "IPPO_L100": ("IPPO", "simple_adversary_v3", 5000,
                  ["--reset_seed", "100"]),
    "MAPPO_attention_N30": ("MAPPO", "simple_spread_v3", 5000,
                            ["--N", "30", "--trick", "attention"]),
}
# each tag's seeds where not the script's 0 / 10 / 100: the four IPPO_L100
# runs of the committed IPPO_L100_4_seed stack, all on layout 100
# (results/r5_marl_fixups.log records 100 and 1100; the JAX package at this
# commit gives 3100 and 4100 the first episodes of its last two rows, as
# close as it gives 100 and 1100 theirs, tests/test_torch_r5_marl_n5.py),
# and the one N=30 run
N5_SEEDS = {"IPPO_L100": (100, 1100, 3100, 4100), "MAPPO_attention_N30": (0,)}
# the slack of IPPO_5000, whose SPECS row has a floor only: MARL_SLACK's
# rule for IPPO (SPECS' slack for IPPO on its env)
N5_SLACK = {"IPPO_5000": MARL_SLACK["IPPO"]}


def n5_argv(tag: str, seed, results_root: Optional[str] = None) -> list:
    """The CLI argv scripts/r5_marl_n5.py passes for one seed of ``tag``
    (fixed reset, 8 envs; without ``--results_root`` and
    ``--no_tensorboard`` where ``results_root`` is None)."""
    algo, env_name, episodes, extra = N5_RUNS[tag]
    out = ["--algo", algo, "--env_name", env_name, "--max_episodes",
           str(episodes), "--num_envs", "8", "--seed", str(seed)]
    if results_root is not None:
        out += ["--results_root", results_root, "--no_tensorboard"]
    return out + list(extra) + ["--fixed_reset"]


def n5_rows(tag: str) -> List[ParityRow]:
    """The tag's two rows, ``<env>/<TAG>_<k>_seed`` over its seeds, against
    the JAX package's committed stack (scripts/r5_marl_n5.py's output) and
    against JAX at this commit: the gate fields of the SPECS row of the
    stem (with ``N5_SLACK``), stacked raw as the per-agent mean return per
    episode, as the JAX script stacks it."""
    env_name = N5_RUNS[tag][1]
    seeds = N5_SEEDS.get(tag, (0, 10, 100))
    stem = f"{tag}_{len(seeds)}_seed"
    spec = spec_of(env_name, stem)
    note = f"r5_marl_n5 {tag}; JAX SPECS gate of {env_name}/{stem}"
    if tag in N5_SLACK:
        note += f" with slack {N5_SLACK[tag]}"
    return [parity_row(spec, ref_path=f"{env_name}/{stem}.npy", ref_paths=(),
                       slack=N5_SLACK.get(tag, spec.slack),
                       pending=False, note=note,
                       regen=tuple(n5_argv(tag, "{seed}")),
                       regen_seeds=seeds, ref=ref, smooth=False)
            for ref in ("committed", "jax_head")]


# scripts/train_spread.py's run (its argparse defaults, lines 24-35): tag ->
# (algo, env, episodes, seed, envs, chunk_size, updates_per_burst), with
# random resets (the script takes no --fixed_reset). The CLI's training
# loop takes MARLConfig's chunk, 128, the script's
SPREAD_RUNS = {"MASAC_40k": ("MASAC", "simple_spread_v3", 40_000, 0, 16, 128,
                             1)}
# the script builds ``MASACConfig(num_envs=16)``, whose batch (256) and
# replay (1e6) are not the CLI's defaults (64, 2e5), and whose lrs (1e-4)
# the CLI keeps when it is given none
SPREAD_CONFIG_ARGV = ["--batch_size", "256", "--buffer_size", "1000000"]
# the script's curve is kept as 600 bin means (freerl_tpu/train/golden.py's
# MASAC_40k row); the slack holds the port to the FreeRL reference's -10.4,
# the bar that row holds the JAX package to at slack 0
SPREAD_BINS, SPREAD_SLACK = 600, 2.8


def spread_argv(tag: str, seed, results_root: Optional[str] = None) -> list:
    """The port's CLI argv that builds the algorithm config and the
    ``MARLConfig`` scripts/train_spread.py builds for one seed of ``tag``
    (without ``--results_root`` and ``--no_tensorboard`` where
    ``results_root`` is None)."""
    algo, env_name, episodes, _, num_envs, _, upb = SPREAD_RUNS[tag]
    out = ["--algo", algo, "--env_name", env_name, "--max_episodes",
           str(episodes), "--num_envs", str(num_envs), "--seed", str(seed)]
    if results_root is not None:
        out += ["--results_root", results_root, "--no_tensorboard"]
    return out + ["--updates_per_burst", str(upb)] + SPREAD_CONFIG_ARGV


def bin_curve(curve, n_bins: int = SPREAD_BINS) -> np.ndarray:
    """A run's curve as ``n_bins`` bin means: the per-agent mean return per
    episode of an ``(episodes, n_agents)`` curve (a 1-D curve as it is),
    averaged over bins whose edges are ``np.linspace(0, episodes, n_bins +
    1).astype(int)`` (66 or 67 episodes a bin at 40,000 and 600)."""
    c = np.asarray(curve)
    c = c.mean(axis=1) if c.ndim == 2 else c
    edges = np.linspace(0, len(c), n_bins + 1).astype(int)
    return np.array([c[a:b].mean() for a, b in zip(edges[:-1], edges[1:])],
                    dtype=c.dtype)


def spread_rows(tag: str) -> List[ParityRow]:
    """The tag's two rows, ``<env>/<TAG>_1_seed``, against the JAX
    package's committed stack and against JAX at this commit: the SPECS
    row's window with ``SPREAD_SLACK``, the recipe ``spread_argv``, and
    each run stacked as ``bin_curve`` of its raw curve."""
    _, env_name, _, seed, _, _, _ = SPREAD_RUNS[tag]
    stem = f"{tag}_1_seed"
    spec = spec_of(env_name, stem)
    note = (f"train_spread {tag}; JAX SPECS window of {env_name}/{stem}, "
            f"{SPREAD_BINS} bins, slack {SPREAD_SLACK}")
    return [parity_row(spec, ref_path=f"{env_name}/{stem}.npy", ref_paths=(),
                       slack=SPREAD_SLACK, pending=False, note=note,
                       regen=tuple(spread_argv(tag, "{seed}")),
                       regen_seeds=(seed,), ref=ref, smooth=False,
                       bins=SPREAD_BINS)
            for ref in ("committed", "jax_head")]


def more_seeds(row: ParityRow, seeds: tuple) -> ParityRow:
    """A 3-seed ``@jax_head`` row's recipe and gate over ``seeds``, its stem
    ``_3_`` made ``_<k>_``."""
    k = f"_{len(seeds)}_"
    return dataclasses.replace(
        row, algo=row.algo.replace("_3_", k),
        ref_path=row.ref_path.replace("_3_", k), regen_seeds=seeds,
        note=f"{len(seeds)} seeds of {row.note}")


# scripts/envelope_seed_sweep.sh's training command (its lines 24-29), the
# 1-env recipe of 24 of the JAX package's 28 ENVELOPE draws, among them the
# committed best (results/envelope_runs_summary.json): tag -> (algo, env,
# episodes, envs, updates_per_burst, extra argv). One learner
# step an env step; a checkpoint every 125 episodes, which also makes the
# driver read its episode count every chunk
ENVELOPE_RUNS = {"ENVELOPE": ("ENVELOPE", "deep-sea-treasure-v0", 5000, 1, 1,
                              ["--batch_size", "256", "--buffer_size",
                               "1000000", "--start_steps", "500",
                               "--save_freq", "125"])}


def envelope_argv(seed, results_root: Optional[str] = None,
                  tag: str = "ENVELOPE") -> list:
    """The CLI argv of scripts/envelope_seed_sweep.sh for one seed, in its
    order (without ``--results_root`` and ``--no_tensorboard`` where
    ``results_root`` is None)."""
    algo, env_name, episodes, num_envs, upb, extra = ENVELOPE_RUNS[tag]
    out = ["--algo", algo, "--env_name", env_name, "--max_episodes",
           str(episodes), "--num_envs", str(num_envs), "--updates_per_burst",
           str(upb), *extra, "--seed", str(seed)]
    if results_root is not None:
        out += ["--results_root", results_root, "--no_tensorboard"]
    return out


def envelope_rows() -> List[ParityRow]:
    """The recipe's two rows over ``DQN_LL_SEEDS16``, against JAX at this
    commit only (the committed stacks are the best of 28 JAX draws):
    ``ENVELOPE_16_seed``, each seed's raw 5,000-episode training curve,
    with SPECS ``ENVELOPE_1_seed``'s window and slack, and
    ``ENVELOPE_sweep_16_seed``, each seed's 100 scalarized sweep returns
    (``reward.npy``), with SPECS ``ENVELOPE_sweep_1_seed``'s window, slack
    and floor; both stacked raw, held on the best seed, and made by one
    training a seed, swept right after it."""
    env = ENVELOPE_RUNS["ENVELOPE"][1]
    k = len(DQN_LL_SEEDS16)
    out = []
    for stem, curve_file in (("ENVELOPE", ""), ("ENVELOPE_sweep",
                                                 "reward.npy")):
        algo = f"{stem}_{k}_seed"
        out.append(parity_row(
            spec_of(env, f"{stem}_1_seed"), algo=algo,
            ref_path=f"{env}/{algo}.npy", ref_paths=(), agg="best",
            pending=False, regen=tuple(envelope_argv("{seed}")),
            regen_seeds=DQN_LL_SEEDS16, ref="jax_head", smooth=False,
            then_sweep=True, curve_file=curve_file,
            note=f"envelope_seed_sweep.sh over {k} seeds; JAX SPECS gate "
                 f"of {env}/{stem}_1_seed, best seed"))
    return out


# scripts/pixel_curve.py's run (its lines 39-47), verbatim: tag -> (env,
# DQNConfig's arguments but ``obs_shape``, which is the env's, and
# OffPolicyConfig's but ``seed``, which is the script's ``--seed``). Neither
# CLI builds a conv trunk, so its rows run the script (``script``), whose
# only argv of the recipe is ``--seed``
PIXEL_RUNS = {"DQN_pixel": (
    "PixelCartPole-v1",
    dict(buffer_size=100_000, batch_size=64, conv_arch="small",
         cnn_features=128),
    dict(num_envs=8, max_episodes=400, start_steps=1000,
         updates_per_burst=4, chunk_size=128))}


def pixel_rows() -> List[ParityRow]:
    """scripts/pixel_curve.py's two rows (ROADMAP A3.5): the port's seed 0
    against SPECS ``PixelCartPole-v1/DQN_seed_0``'s floor (the SPECS row
    has no reference curve), and ``DQN_16_seed@jax_head`` over
    ``DQN_LL_SEEDS16``, held by ``seed_rule`` against JAX at this commit;
    both stacked raw, one run of the script a seed."""
    env = PIXEL_RUNS["DQN_pixel"][0]
    spec = spec_of(env, "DQN_seed_0")
    common = dict(regen=("--seed", "{seed}"), smooth=False, pending=False,
                  script="pixel_curve")
    return [
        parity_row(spec, regen_seeds=(0,), note=f"pixel_curve.py seed 0; "
                   f"SPECS floor {spec.floor}", **common),
        parity_row(spec, algo="DQN_16_seed", ref_path=f"{env}/DQN_16_seed.npy",
                   regen_seeds=DQN_LL_SEEDS16, ref="jax_head", rule="seeds",
                   note=f"pixel_curve.py over 16 seeds: both means >= "
                        f"{spec.floor}, Mann-Whitney p >= {P_MIN}",
                   **common)]


# scripts/r5_cem_bipedal.py's recipe (its lines 44-79), verbatim: the row's
# stem -> (env, the reset seed FixedResetWrapper pins, CEMGD3PGConfig's
# arguments, train_cem_gd3pg's arguments but ``seed``, which is ``seed +
# 1000 * run``). A seed of the row is a run (a draw): every draw trains on
# the terrain seed 0 pins, with its own training seed
CEM_BIPEDAL_RUNS = {"CEM_GD3PG_4_seed": (
    "BipedalWalker-v3", 0, dict(batch_size=256, buffer_size=1_000_000),
    dict(max_episodes=500, start_steps=1000, full_ratio=True))}


def cem_bipedal_seed(run: int, seed: int = 0) -> int:
    """The training seed of draw ``run``: ``seed + 1000 * run``, as the JAX
    script seeds it."""
    return seed + 1000 * run


def cem_bipedal_rows() -> List[ParityRow]:
    """scripts/r5_cem_bipedal.py's row: the port's 4 draws (runs 0-3)
    against the JAX package's committed 4-draw stack, with SPECS'
    gate of the stem (window 50, slack 300, floor -110.5, best draw);
    stacked raw, one run of the port's script a draw."""
    stem = "CEM_GD3PG_4_seed"
    env = CEM_BIPEDAL_RUNS[stem][0]
    spec = spec_of(env, stem)
    return [parity_row(spec, ref_path=f"{env}/{stem}.npy", ref_paths=(),
                       regen=("--run", "{seed}"), regen_seeds=(0, 1, 2, 3),
                       smooth=False, pending=False, script="r5_cem_bipedal",
                       note=f"r5_cem_bipedal.py over 4 draws; SPECS gate of "
                            f"{env}/{stem} (best draw, floor {spec.floor})")]


# scripts/gail_e2e.py's run (its lines 31-36): the gate of ``SCALAR_GATES``
# its summary feeds -> the script's arguments at their defaults
GAIL_RUNS = {"GAIL_Pendulum_eval": dict(
    expert_episodes=3000, gail_iters=800, n_expert_transitions=20_000,
    seed=0)}


# ROADMAP A3.5's rule for a ``rule='seeds'`` row: over the seeds of its
# recipe that both sides keep, at least ``MIN_SEEDS`` of them, both sides'
# mean final-window clears the row's floor and the two-sided Mann-Whitney p
# of their per-seed final-windows is at least ``P_MIN``
P_MIN, MIN_SEEDS = 0.05, 8


def both_sides(row: GoldenSpec) -> tuple:
    """The seeds of ``row``'s recipe that the port keeps under
    ``OURS_ROOT`` and the JAX package under the row's reference tree
    (``kept_seed``), in the row's order, and each side's per-seed
    final-``window`` means over them: ``(seeds, port, jax)``."""
    seeds = [s for s in row.regen_seeds
             if kept_seed(OURS_ROOT, row, s)
             and kept_seed(ref_root(row), row, s)]
    means = [np.array([float(np.load(seed_file(root, row, s))[-row.window:]
                             .mean()) for s in seeds])
             for root in (OURS_ROOT, ref_root(row))]
    return seeds, means[0], means[1]


def seed_rule(row: GoldenSpec) -> dict:
    """``check``'s row for a ``rule='seeds'`` row: 'pass' or 'FAIL' by the
    rule above, 'waiting' with fewer than ``MIN_SEEDS`` seeds on both
    sides, and the Mann-Whitney p and the seeds under ``p`` and
    ``seeds``."""
    from scipy.stats import mannwhitneyu

    seeds, port, jax = both_sides(row)
    ours = float(port.mean()) if len(seeds) else None
    ref = float(jax.mean()) if len(seeds) else None
    p, status = None, "waiting"
    if len(seeds) >= MIN_SEEDS:
        p = float(mannwhitneyu(port, jax, alternative="two-sided").pvalue)
        ok = min(ours, ref) >= row.floor and p >= P_MIN
        status = "pass" if ok else "FAIL"
    return {
        "env": row.env, "algo": row.algo, "ours": ours, "ref": ref,
        "slack": row.slack, "status": status, "note": row.note,
        "ours_seeds": [round(float(x), 1) for x in port],
        "ref_seeds": [round(float(x), 1) for x in jax],
        "seed_overlap": None, "p": p, "seeds": seeds,
    }


JAX_PARITY: List[GoldenSpec] = [
    GoldenSpec(
        # scripts/torch_northstar.py at 4096 envs x 8 updates x 150M env
        # steps, seed 0, against r5_northstar.py's point (final-1000
        # 196.85): its parity bar (123.0) as the floor, and the slack the
        # DQN_3_seed row gives this env and algorithm
        "LunarLander-v2", "DQN_fast_1_seed",
        "LunarLander-v2/DQN_fast_1_seed.npy",
        window=1000, slack=50.0, floor=123.0,
        note="north star: final-1000 >= 196.85 - 50 and >= 123.0",
    ),
    # the golden row of SPECS (its recipe, seeds, window and slack)
    dataclasses.replace(
        SPECS[0], ref_path="LunarLander-v2/DQN_3_seed.npy",
        note="JAX per-seed final-50 81.5 / 227.5 / 181.8 (mean 163.6)"),
    # the same row, and its recipe over 16 seeds, against the JAX package
    # run at this commit
    parity_row(SPECS[0], ref_path="LunarLander-v2/DQN_3_seed.npy",
               ref="jax_head", note="SPECS[0] against JAX at this commit"),
    parity_row(SPECS[0], algo="DQN_16_seed",
               ref_path="LunarLander-v2/DQN_16_seed.npy",
               regen_seeds=DQN_LL_SEEDS16, ref="jax_head",
               note="SPECS[0]'s gate over 16 seeds, against JAX at this "
                    "commit"),
    parity_row(SPECS[0], algo="DQN_48_seed",
               ref_path="LunarLander-v2/DQN_48_seed.npy",
               regen_seeds=DQN_LL_SEEDS48, ref="jax_head",
               note="SPECS[0]'s gate over 48 seeds, against JAX at this "
                    "commit"),
] + [row for tag in R5_RUNS if tag not in R5_LATER for row in r5_rows(tag)] + [
    # the FrozenLake row over the 16 seeds, against JAX at this commit
    dataclasses.replace(
        r5_rows("DQN_FrozenLake")[1], algo="DQN_16_seed",
        ref_path="FrozenLake-v1/DQN_16_seed.npy", regen_seeds=DQN_LL_SEEDS16,
        note="r5 DQN_FrozenLake over 16 seeds; JAX SPECS gate of "
             "FrozenLake-v1/DQN_10_seed"),
    # SAC Pendulum over the 16 seeds, every seed from the start seed 0 pins
    # (ROADMAP C13), against JAX at this commit
    dataclasses.replace(
        r5_rows("SAC_Pendulum")[1], algo="SAC_16_seed",
        ref_path="Pendulum-v1/SAC_16_seed.npy",
        regen=tuple(r5_argv("SAC_Pendulum", "{seed}")) + ("--reset_seed",
                                                           "0"),
        regen_seeds=DQN_LL_SEEDS16,
        note="r5 SAC_Pendulum over 16 seeds from seed 0's start; gate of "
             "Pendulum-v1/SAC_1_seed"),
] + mountaincar_rows() + a2_rows() + [
    row for algo in MARL_RUNS for row in marl_rows(algo)] + [
    # the recipes of Pendulum DQN (ROADMAP C14), CartPole REINFORCE (C15),
    # MountainCarContinuous PPO ObsNorm (C16) and DDPG OUNoise (C17) over
    # the 16 seeds, against JAX at this commit
    more_seeds(row, DQN_LL_SEEDS16)
    for row in a2_rows() if row.ref == "jax_head"
    and (row.env, row.algo) in SEEDS16_STEMS] + [
    row for tag in N5_RUNS for row in n5_rows(tag)] + [
    # C16's recipe over the 48 and the 96 seeds and C18's over the 16
    # (ROADMAP queue C's rules for seeds), against JAX at this commit
    more_seeds(next(r for r in a2_rows() if row_key(r) ==
                    "MountainCarContinuous-v0/PPO_ObsNorm_3_seed@jax_head"),
               seeds) for seeds in (DQN_LL_SEEDS48, DQN_LL_SEEDS96)] + [
    more_seeds(n5_rows("MAAC_N5")[1], DQN_LL_SEEDS16),
] + [row for tag in SPREAD_RUNS for row in spread_rows(tag)] + [
    pixel_rows()[0]] + cem_bipedal_rows()

# rows whose recipe the port runs and keeps, but that no gate holds yet:
# their reference is not made. ENVELOPE's recipe in the JAX package at this
# commit takes ~0.13 s a learner step on an 8-core CPU (a 32,768-row batch
# a step), 1.2-5.1 hours a seed (ROADMAP A3.4); the 16-seed pixel row waits
# for ``MIN_SEEDS`` JAX seeds (ROADMAP A3.5)
RUN_ONLY: List[GoldenSpec] = envelope_rows() + [pixel_rows()[1]]


def recipe_row(key: str) -> GoldenSpec:
    """The row of ``JAX_PARITY`` or ``RUN_ONLY`` keyed ``key``
    (``row_key``)."""
    for row in JAX_PARITY + RUN_ONLY:
        if row_key(row) == key:
            return row
    raise KeyError(f"{key!r} is not a row of golden.JAX_PARITY or RUN_ONLY")


# rows of JAX_PARITY (by ``row_key``), and gates of SCALAR_GATES (by name),
# whose committed port result misses its gate, with the open fault of
# ROADMAP's queue C that tracks each: such a row must read FAIL until the
# fault is closed. C20: the port's scripts/gail_e2e.py seed 0 reads
# gail_eval_avg -402.8 against the gate's -190.0; over seeds 0-7 a side
# (the port's on the card, results/torch/gail/Pendulum-v1/; the JAX
# package's at this commit on the CPU, results/torch/jax_head/gail/) the
# port reads -88.7 to -402.8 (mean -153.3, 7 of 8 past the gate) against
# -198.3 to -819.5 (mean -388.0, none), Mann-Whitney p 0.0030: the two
# differ, so C20 stays open as a fault of the port
# (scripts/torch_seed_spread.py --gail)
OPEN_FAULTS: dict = {"GAIL_Pendulum_eval": "C20"}
# rows whose seeds would train on another task in each package, each with
# the reason: checked and printed, but held to nothing (neither a pass nor a
# fault). ``--fixed_reset`` pins every episode to the start the seed draws,
# and the port pins the JAX package's own draw (``envs/base.py``,
# ``core/jax_prng.py``), so no fixed-reset row is here; a test derives the
# set from both packages' starts
NOT_COMPARABLE: dict = {}
# rows whose committed port curve misses a committed JAX curve that the JAX
# package at this commit misses too (ROADMAP's rule for a stale reference),
# each with the file that shows it: such a row keeps its gate and must read
# FAIL. MAAC at N=5: JAX at this commit reads -13.33 over the three seeds
# against the committed gate's -13.31 (C18)
STALE_REFERENCES: dict = {
    "simple_spread_v3/MAAC_N5_3_seed":
        "results/torch/jax_head/simple_spread_v3/MAAC_N5_3_seed.npy"}
# rows whose gate, not the port, misses, each with the evidence: the row of
# the same recipe over more seeds that shows it, or the committed file that
# does. Such a row keeps its gate and must read FAIL. By ROADMAP queue C's
# rule for seeds (the row over more seeds passes, and neither the final-50s
# nor the counts of seeds in each mode of the two sides differ, p >= 0.05)
# C9 closed: over 48 seeds a side the port's mean final-50 is 96.1 against
# 106.2, and 24 against 25 seeds break out; and C13: over 16 seeds from
# seed 0's start -162.4 against -175.1, and 5 against 7 seeds settle on
# the -236 policy. C12 closed as a gate that samples too thinly:
# FrozenLake's best final-50 is a 50-episode sample of a
# greedy-with-epsilon policy; each seed's final net scored greedily over
# 1,000 episodes by one evaluator gives the port a best of 0.224 against
# JAX's 0.234, Mann-Whitney p 0.939 over the 16 seeds a side. C14, C15
# and C17 closed by the rule for seeds over 16 a side: Pendulum DQN -186.6
# against -177.7 (p 0.109), CartPole REINFORCE 368.8 against 404.1 (p
# 0.356), MountainCarContinuous DDPG OUNoise's best seed 88.8 against 89.4
# (gate 88.4, p 0.33), and C18: MAAC at N=5 over 16 seeds -15.5 against
# -12.0 (gate -16.0, p 0.057). C16 closed by its rule over 96 seeds a side,
# after the port's ObsNorm path held to the JAX package's step by step
# (results/torch/c16_lockstep.json): the port's mean final-50 70.7 against
# 74.9 (gate 69.9), 73 against 77 of 96 seeds solve (p 0.465 and 0.601)
UNDERPOWERED = {
    "simple_spread_v3/MAAC_N5_3_seed@jax_head":
        "simple_spread_v3/MAAC_N5_16_seed@jax_head",
    "LunarLander-v2/DQN_3_seed": "LunarLander-v2/DQN_48_seed@jax_head",
    "LunarLander-v2/DQN_16_seed@jax_head":
        "LunarLander-v2/DQN_48_seed@jax_head",
    "Pendulum-v1/SAC_1_seed": "Pendulum-v1/SAC_16_seed@jax_head",
    "Pendulum-v1/SAC_1_seed@jax_head": "Pendulum-v1/SAC_16_seed@jax_head",
    "FrozenLake-v1/DQN_3_seed@jax_head": "results/torch/c12_greedy.json",
    "FrozenLake-v1/DQN_16_seed@jax_head": "results/torch/c12_greedy.json",
    **{f"MountainCarContinuous-v0/PPO_ObsNorm_{stem}":
       "MountainCarContinuous-v0/PPO_ObsNorm_96_seed@jax_head"
       for stem in ("3_seed", "3_seed@jax_head", "16_seed@jax_head",
                    "48_seed@jax_head")},
    **{f"{env}/{stem}_3_seed{ref}": f"{env}/{stem}_16_seed@jax_head"
       for env, stem in (("Pendulum-v1", "DQN"), ("CartPole-v1", "REINFORCE"),
                         ("MountainCarContinuous-v0", "DDPG_OUNoise"))
       for ref in ("", "@jax_head")},
}


def must_fail(key: str) -> bool:
    """Whether the row of ``key`` (``row_key``) is held to read FAIL: an
    open fault tracks it, its reference is stale, or its gate, not the
    port, misses."""
    return (key in OPEN_FAULTS or key in STALE_REFERENCES
            or key in UNDERPOWERED)


def breaks_hold(key: str, status: str) -> bool:
    """Whether a checked row's ``status`` ('pass' or 'FAIL') breaks what
    the row of ``key`` is held to: a row held to fail passes, or another
    row fails; a row of ``NOT_COMPARABLE`` is held to nothing."""
    if key in NOT_COMPARABLE:
        return False
    return (status == "FAIL") != must_fail(key)


def check_against_jax(row: GoldenSpec) -> dict:
    """``check`` of ``row`` with the reference read from the tree the row
    names (``ref_root``; the JAX package's committed curves,
    ``JAX_CURVES_ROOT``, by default): a port curve that is absent reads
    ``missing``. A ``rule='seeds'`` row is held by ``seed_rule``."""
    if getattr(row, "rule", "") == "seeds":
        return seed_rule(row)
    return check(row, ref_root=ref_root(row))


def _has_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def regen_argv(spec: GoldenSpec, seed: int, results_root: str = "results",
               device: str = "cuda") -> list:
    """The port's CLI argv of one seed of ``spec``'s recipe, its run dir
    under ``<results_root>/golden_runs``."""
    if not spec.regen:
        raise ValueError(f"{spec.env}/{spec.algo} has no regen recipe")
    return [a.format(seed=seed) for a in spec.regen] + [
        "--results_root", os.path.join(results_root, "golden_runs"),
        "--no_tensorboard", "--device", device,
    ]


def seed_curve(spec: GoldenSpec, run_dir: str, seed: int) -> np.ndarray:
    """The curve one seed's CLI run saved in ``run_dir`` (the row's
    ``curve_file`` there, where it names one)."""
    if getattr(spec, "curve_file", ""):
        return np.load(os.path.join(run_dir, spec.curve_file))
    algo_name = spec.regen[spec.regen.index("--algo") + 1]
    return np.load(os.path.join(run_dir, f"{algo_name}_seed_{seed}.npy"))


def _label(spec: GoldenSpec) -> str:
    return spec.algo.rsplit("_", 2)[0]     # 'DQN_3_seed' -> 'DQN'


def seed_file(root: str, spec: GoldenSpec, seed: int) -> str:
    """Where one seed's raw curve of ``spec``'s recipe is kept under
    ``root``: ``<root>/<env>/seeds/<label>_seed_<seed>.npy``, shared by the
    rows of one recipe whatever their seed count; a recipe that pins its
    start with ``--reset_seed R`` keeps its seeds as
    ``<label>_reset<R>_seed_<seed>.npy``, apart from the recipe without
    it."""
    label = _label(spec)
    if "--reset_seed" in spec.regen:
        label += f"_reset{spec.regen[spec.regen.index('--reset_seed') + 1]}"
    return os.path.join(root, spec.env, "seeds", f"{label}_seed_{seed}.npy")


# flags of a CLI run that say where and how it runs, not what it trains,
# with the count of values each takes
# (``--and_sweep``: scripts/torch_envelope_e2e.py's run of the CLI argv
# that sweeps the run dir after training; ``--cpu``: a JAX script's run on
# the CPU, scripts/pixel_curve.py's)
_RUN_FLAGS = {"--results_root": 1, "--no_tensorboard": 0, "--device": 1,
              "--and_sweep": 0, "--cpu": 0}


def recipe_of(command: str) -> list:
    """The recipe of a recorded CLI command (a provenance ``command``): its
    words after ``-m MODULE``, up to a ``&&`` that chains another command,
    without the flags of ``_RUN_FLAGS``."""
    import shlex

    words = shlex.split(command)
    words = words[words.index("-m") + 2:]
    if "&&" in words:
        words = words[:words.index("&&")]
    out, i = [], 0
    while i < len(words):
        n = _RUN_FLAGS.get(words[i])
        if n is None:
            out.append(words[i])
        i += 1 if n is None else 1 + n
    return out


def start_seed(spec: GoldenSpec, seed: int) -> int:
    """The seed whose start one seed of ``spec``'s recipe pins under
    ``--fixed_reset``: the recipe's ``--reset_seed``, else ``seed``."""
    if "--reset_seed" in spec.regen:
        return int(spec.regen[spec.regen.index("--reset_seed") + 1])
    return seed


def pinned(spec: GoldenSpec, seed: int, device: str = "cpu"):
    """What every episode of one seed of ``spec``'s recipe begins from, as
    the port's CLI builds its env on ``device`` (``cli.build_env``): the
    pinned reset draw (on the CPU) and the start observation (a list of
    floats), or None where the recipe takes no ``--fixed_reset``."""
    import torch

    from freerl_tpu_torch import cli

    argv = [a.format(seed=seed) for a in spec.regen]
    if "--fixed_reset" not in argv:
        return None
    env = cli.build_env(cli.parser().parse_args(argv + ["--device", device]))
    _, obs = env.reset(env.draw_reset(1, torch.Generator(device=device)))
    return (env._reset_draw.cpu(),
            [float(x) for x in obs[0].reshape(-1).tolist()])


def pinned_start(spec: GoldenSpec, seed: int,
                 device: str = "cpu") -> Optional[list]:
    """The start observation of ``pinned``, or None."""
    got = pinned(spec, seed, device)
    return None if got is None else got[1]


# how many float32 ulps two computations of one start may part by: the
# devices and the packages compute cos, sin and the physics of one draw with
# their own float32 kernels (PyTorch's CUDA division by a scalar multiplies
# by its reciprocal; XLA fuses the JAX env's scaling), and LunarLander's
# start velocity parts by 2 ulps between the H100 and the CPU
START_ULPS = 2


def start_ulps(a: list, b: list) -> float:
    """The largest distance between two start observations of one shape,
    value by value, in float32 ulps (of the larger of the two values)."""
    x, y = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ulp = np.maximum(np.spacing(np.abs(x)), np.spacing(np.abs(y)))
    gap = np.abs(x.astype(np.float64) - y.astype(np.float64))
    return float(np.max(gap / ulp.astype(np.float64), initial=0.0))


def same_start(a: Optional[list], b: Optional[list]) -> bool:
    """Whether two recorded start observations are one start: as many
    values, each within ``START_ULPS`` float32 ulps of the other's."""
    if a is None or b is None:
        return a is b
    return (np.shape(a) == np.shape(b)
            and start_ulps(a, b) <= START_ULPS)


def kept_seed(root: str, spec: GoldenSpec, seed: int,
              start: Optional[list] = None) -> bool:
    """Whether one seed of ``spec``'s recipe is kept under ``root``: its
    ``seed_file`` is there and the env's provenance records that it ran
    this recipe, and, where the recipe takes ``--fixed_reset``, from the
    start ``start`` (``same_start``; by default the one the port pins now,
    ``pinned_start``). A file that another recipe made (the
    rows of one label share a file name), that has no record, or whose
    record names no start or another one raises ``ValueError``: it must not
    be stacked as this recipe's seed."""
    import json

    path = seed_file(root, spec, seed)
    if not os.path.isfile(path):
        return False
    prov_path = os.path.join(root, spec.env, "provenance.json")
    rec = None
    if os.path.isfile(prov_path):
        with open(prov_path) as f:
            rec = json.load(f).get("seeds", {}).get(os.path.basename(path))
    want = [a.format(seed=seed) for a in spec.regen]
    if rec is None or recipe_of(rec["command"]) != want:
        made = "no provenance record" if rec is None else rec["command"]
        raise ValueError(
            f"{path} is not a seed of {row_key(spec)}'s recipe {want} "
            f"({made}): move it aside, or run the seed again (--force)")
    if "--fixed_reset" in want:
        start = pinned_start(spec, seed) if start is None else start
        if not same_start(rec.get("start"), start):
            made = ("no start record" if "start" not in rec
                    else f"start {rec['start']}")
            raise ValueError(
                f"{path} ran {row_key(spec)}'s recipe from another start "
                f"than {start} ({made}): run the seed again (--force)")
    return True


def parse_run_log(text: str) -> dict:
    """The run dir and the final counts that a CLI run prints (the JAX
    package's and the port's print the same lines), and the launches of
    the sum-tree kernel (B1) in the run, which the port's CLI prints."""
    import re

    run_dir = re.search(r"^model_dir: (.+)$", text, re.M).group(1).strip()
    m = re.search(r"episodes: (\d+)\s+env_steps: (\d+)\s+steps/s: (\d+)",
                  text)
    out = dict(run_dir=run_dir, episodes=int(m.group(1)),
               env_steps=int(m.group(2)), steps_per_s=int(m.group(3)))
    b1 = re.search(r"^sumtree_descend launches: (\d+)$", text, re.M)
    if b1 is not None:
        out["b1_launches"] = int(b1.group(1))
    return out


def update_provenance(root: str, env: str, seeds: Optional[dict] = None,
                      stacks: Optional[dict] = None) -> str:
    """Merge records into ``<root>/<env>/provenance.json``: ``seeds`` maps
    a kept seed file's name (``seed_file``) to how it was made, ``stacks``
    a stem to the seed files it stacks. The file is read and rewritten
    under an exclusive ``flock``, so the seeds of one env that finish
    together in processes of their own all keep their records. Returns
    the file's path."""
    import fcntl
    import json

    path = os.path.join(root, env, "provenance.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        f.seek(0)
        text = f.read()
        prov = json.loads(text) if text.strip() else {}
        prov.setdefault("seeds", {}).update(seeds or {})
        prov.setdefault("stacks", {}).update(stacks or {})
        f.seek(0)
        f.truncate()
        json.dump(prov, f, indent=1, sort_keys=True)
    return path


def stack_record(spec: GoldenSpec) -> dict:
    """The ``stacks`` entry of ``update_provenance`` for ``spec``'s
    stack."""
    return {spec.algo: dict(
        seeds=list(spec.regen_seeds), smoothed=getattr(spec, "smooth", True),
        **({"bins": spec.bins} if getattr(spec, "bins", 0) else {}),
        files=[os.path.basename(seed_file("", spec, s))
               for s in spec.regen_seeds])}


def stack_curves(spec: GoldenSpec, curves: List[np.ndarray],
                 out_dir: str) -> str:
    """Stack the per-seed curves as ``<out_dir>/<spec.algo>.npy``:
    smoothed (alpha 0.9) and cut to the shortest, or, for a row with
    ``smooth=False``, raw and cut to the shortest. A multi-agent run's
    curve, ``(episodes, n_agents)`` as both CLIs save it, is stacked as its
    per-agent mean return per episode, the layout of the JAX package's
    committed MARL curves (one row a run), and, for a row with ``bins``,
    as that mean's ``bin_curve``. Returns its path."""
    from freerl_tpu_torch.train.plotting import save_seed_stack

    if getattr(spec, "smooth", True):
        return save_seed_stack(curves, _label(spec), out_dir)
    bins = getattr(spec, "bins", 0)
    curves = [bin_curve(c, bins) if bins else c.mean(axis=1) if c.ndim == 2
              else c for c in map(np.asarray, curves)]
    t = min(len(c) for c in curves)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, spec.algo + ".npy")
    np.save(path, np.stack([c[:t] for c in curves]))
    return path


def save_stack(spec: GoldenSpec, curves: List[np.ndarray]) -> str:
    """Stack the per-seed curves into ``<label>_<k>_seed.npy`` under
    ``OURS_ROOT/<env>`` (``stack_curves``), with its plot where they are
    smoothed. Returns the PNG's path, or the stacked curve's where the
    curves are raw or matplotlib is not installed (the plot is then not
    drawn)."""
    from freerl_tpu_torch.train.plotting import plot_learning_curve

    out_dir = os.path.join(OURS_ROOT, spec.env)
    if not getattr(spec, "smooth", True) or not _has_matplotlib():
        return stack_curves(spec, curves, out_dir)
    return plot_learning_curve(curves, label=_label(spec), out_dir=out_dir,
                               env_name=spec.env)


def regenerate(spec: GoldenSpec, results_root: str = "results",
               device: str = "cuda") -> str:
    """Re-run a golden curve from scratch through the port's CLI on
    ``device`` (the nightly-golden path: artifacts are reproduced, not just
    pinned).

    Runs one CLI training per seed in ``spec.regen_seeds``, one after
    another in this process, then stacks the per-seed curves with
    ``save_stack``; returns its path. (``scripts/torch_golden_card.py``
    runs the seeds in parallel, one card each.)
    """
    from freerl_tpu_torch.cli import run as cli_run

    curves = [seed_curve(spec, cli_run(regen_argv(spec, seed, results_root,
                                                  device)), seed)
              for seed in spec.regen_seeds]
    return save_stack(spec, curves)


def print_rows(rows: List[dict], keys: Optional[List[str]] = None) -> None:
    """One line a row; ``keys`` (``row_key``) name the rows in place of
    ``ENV ALGO``."""
    for i, r in enumerate(rows):
        ours = "----" if r["ours"] is None else f"{r['ours']:8.1f}"
        ref = "----" if r["ref"] is None else f"{r['ref']:8.1f}"
        name = (f"{r['env']:28s} {r['algo']:24s}" if keys is None
                else f"{keys[i]:53s}")
        print(f"{r['status']:6s} {name} ours={ours} ref={ref} "
              f"slack={r['slack']:.0f} {r['note']}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--regenerate", action="store_true",
                    help="re-run regen recipes before checking")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the regenerated runs")
    ap.add_argument("targets", nargs="*",
                    help="optional '<env>/<algo>' spec keys to regenerate "
                         "(default: every spec with a recipe)")
    ns = ap.parse_args()
    if ns.regenerate:
        for s in SPECS:
            key = f"{s.env}/{s.algo}"
            if s.regen and (not ns.targets or key in ns.targets):
                print(f"regenerating {key} ...", flush=True)
                print("saved", regenerate(s, device=ns.device), flush=True)
    rows = check_all()
    print_rows(rows)
    parity = [check_against_jax(s) for s in JAX_PARITY]
    keys = [row_key(s) for s in JAX_PARITY]
    print("against the JAX package's curves (results/learning_curves/, and "
          "@jax_head results/torch/jax_head/):")
    print_rows(parity, keys)
    if any(r["status"] == "FAIL" for r in rows) or any(
            r["status"] == "FAIL" and breaks_hold(k, "FAIL")
            for k, r in zip(keys, parity)):
        raise SystemExit(1)
