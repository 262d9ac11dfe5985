"""Multi-process scale-out on ``torch.distributed``: meshes and the launcher,
the collectives with their gradients, the sharding rules, the sharded
inference and training steps, and the GPipe pipeline."""
