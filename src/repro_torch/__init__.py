"""MEMSCOPE on PyTorch and CUDA — the port of ``repro`` to one NVIDIA H100.

Same sub-layout and the same module and function names as the JAX
package, so a reader finds each counterpart.  This package imports
``torch`` and never ``jax``, nor anything of ``repro``.

core/      device tree, pools, workload library, scenario DSL, queueing
           model, coordinator, debugfs-style interface, converters
kernels/   hand-written CUDA C++ kernels (``csrc/``), their ctypes
           wrappers, and the plain PyTorch versions they are held against

Entry points run on the card unless the caller passes ``device="cpu"``;
asked for the card where there is none, they raise.
"""
