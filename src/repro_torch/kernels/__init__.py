"""Hand-written CUDA kernels behind the strategy letters, their ctypes
wrappers, and the plain PyTorch versions they are held against.

csrc/      stream.cu, chase.cu — CUDA C++ for sm_90a, plain C interface
_build     nvcc build at first use + ctypes loading
counts     launch counters (kernel launches / plain-version calls)
stream     read/write/rmw/copy/mixed streams, on-chip residency pair
chase      pointer-chase kernels + the numpy chain initialisers
ref        plain PyTorch versions
ops        the call-site names the workload library uses
"""
