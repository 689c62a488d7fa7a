"""Checkpoints: a manifest and one .npy a leaf, written atomically."""
