"""The batched scenario engine: terrain, SRB physics, the closed-loop rollout."""
