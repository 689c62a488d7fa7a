"""Sharding rules and gradient compression (the one-device subsets)."""
