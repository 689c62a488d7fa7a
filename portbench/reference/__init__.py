"""Plain PyTorch references of the benchmark's model families.

They import nothing of the port, nor ``jax`` nor ``repro``, and take only
the weights and inputs the benchmark made.  They compute in float32 with
TF32 off (``precision="float32"``), or, as the control that a comparison
has to fail, with every matrix product's operands rounded to float8
(``precision="fp8"``, e4m3 forward and e5m2 backward, one scale a tensor).
"""
