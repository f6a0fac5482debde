"""A check for ``chip_smoke.side_by_side`` on the CPU, importable by the
processes it spawns (``tests/test_torch_learning_block.py``): a tiny
``chip_smoke.LEARNING_CHECKS``-style recipe trained through
``chip_smoke.recipe_run``; the check named ``raises`` raises, the one
named ``hangs`` sleeps."""
import time

import torch

import chip_smoke

TINY = {
    "dqn": dict(env="CartPole-v1", algo="DQN",
                algo_cfg=dict(buffer_size=2048, batch_size=32),
                loop=dict(num_envs=4, max_episodes=12, start_steps=64,
                          updates_per_burst=2, chunk_size=32)),
    "ppo": dict(env="CartPole-v1", algo="PPO", driver="onpolicy",
                algo_cfg=dict(horizon=64, minibatch_size=32, num_envs=4,
                              K_epochs=2),
                loop=dict(num_envs=4, max_episodes=12, horizon=64)),
}


def tiny_check(name: str, device: str) -> dict:
    torch.set_num_threads(1)
    if name == "raises":
        raise RuntimeError("a check that fails")
    if name == "hangs":
        time.sleep(600)
    _, _, run = chip_smoke.recipe_run(TINY[name], 0, device)
    _, returns, info = run()
    return dict(returns=returns, env_steps=info["env_steps"])
