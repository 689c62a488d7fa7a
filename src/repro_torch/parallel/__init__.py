"""Sharding rules and specs, the collectives over torch.distributed,
and gradient compression."""
