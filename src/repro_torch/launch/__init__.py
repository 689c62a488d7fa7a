"""Launchers: meshes, and the serving and training entry points."""
