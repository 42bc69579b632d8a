"""The PPO agent that picks the per-edge frequencies (gamma1, gamma2)."""
from repro_torch.core.agent.ppo import PPOAgent, PPOConfig  # noqa: F401
