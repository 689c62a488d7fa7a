"""The optimizer: AdamW with float32 moments and its schedule."""
