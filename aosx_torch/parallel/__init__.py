"""Monte-Carlo evaluation: batched and sustained rollouts, parameter sweeps."""
