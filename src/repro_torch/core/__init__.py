"""HAPFL core on PyTorch: PPO agents (ppo, allocation, intensity), mutual
KD (distill), weighted aggregation (aggregation), and the numpy latency and
population models (copies of the reference's)."""
