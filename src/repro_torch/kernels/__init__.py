"""Hand-written CUDA kernels (behind the strategy letters, the STREAM triad
and flash attention), their ctypes wrappers, and the plain PyTorch versions
they are held against.

csrc/      stream.cu, chase.cu, compute_probe.cu, contention.cu,
           flash_attention.cu — CUDA C++ for sm_90a, plain C interface;
           roles.cuh, the role bodies the stream, chase and contention
           kernels share
_build     nvcc build at first use + ctypes loading
counts     launch counters (kernel launches / plain-version calls)
stream     read/write/rmw/copy/mixed streams, the STREAM triad, on-chip
           residency pair
chase      pointer-chase kernels + the numpy chain initialisers
compute_probe  the memory-idle chain of (128, 128) products (letter i)
contention the multi-engine contention ladder (one persistent kernel) and
           the kernel-support probe
flash_attention  online-softmax attention, causal + sliding window, GQA
ref        plain PyTorch versions
ops        the call-site names the workload library uses
"""
