"""Flash attention (online softmax, causal + sliding window, GQA).

The wrapper of the two CUDA kernels that port
``repro/kernels/flash_attention.py:flash_attention``: blockwise attention
that never materialises the (Sq, Sk) score matrix in device memory.  GQA
maps head ``h`` to KV head ``h·KVH // H`` (no repeated KV), and an
out-of-window or above-diagonal KV tile is never loaded, so a local layer
is O(S·W) in operations and bytes.

Layout: q (B, H, Sq, D); k, v (B, KVH, Sk, D); H % KVH == 0; the output
(B, H, Sq, D) in q's dtype.  Accumulation is float32 for any input dtype.

The dtype picks the kernel by a fixed table, :data:`INSTANCE`: bfloat16
goes to ``csrc/flash_attention_tc.cu`` (``wgmma_bf16``: both products on
Hopper's tensor cores, K/V through TMA), float32 to
``csrc/flash_attention.cu`` (``fma_f32``: float32 FMAs on the CUDA cores,
because a float32 input must hold 2e-5 of the dense oracle and TF32 keeps
about three digits).  Neither stands in for the other: a launch that fails
raises.  A CUDA tensor launches its kernel or raises: the kernels take
head dims 16, 32, 64, 128 and 256 (every configuration's head dim and
``reduced()``'s), and :func:`kernel_refusal` says why they would not take
other inputs.  Only a CPU tensor takes the plain version,
:func:`repro_torch.kernels.ref.flash_attention_ref`, which runs the
reference's algorithm at the given ``block_q``/``block_k``.  The kernels
pick their own tiles for the card; the result does not depend on the
tiling, as the reference's contract says.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, counts, ref

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernel each dtype runs on the card: a fixed table, not a fallback
INSTANCE = {torch.bfloat16: "wgmma_bf16", torch.float32: "fma_f32"}
# instance -> (source under csrc/, C entry point, dtypes it takes); the
# FMA kernel is also built for bfloat16, so that a check can hold the
# tensor-core kernel against it on the same inputs
_ENTRY = {"wgmma_bf16": ("flash_attention_tc", "repro_flash_attention_tc",
                         (torch.bfloat16,)),
          "fma_f32": ("flash_attention", "repro_flash_attention",
                      (torch.float32, torch.bfloat16))}

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                window: int, block_q: int, block_k: int) -> None:
    """What any caller must pass, the card or the CPU."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: want q (B,H,Sq,D) and k, v "
                         f"(B,KVH,Sk,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError("flash_attention: k and v must be (B,KVH,Sk,D) "
                         f"with q's B and D, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)} for q {tuple(q.shape)}")
    kvh, sk = k.shape[1], k.shape[2]
    if min(b, h, sq, d, kvh, sk) < 1:
        raise ValueError("flash_attention: every dimension must be >= 1")
    if h % kvh:
        raise ValueError(f"flash_attention: H {h} not a multiple of KVH {kvh}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError("flash_attention: q, k and v must share a dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention: q, k and v must share a device")
    if window < 0 or block_q < 1 or block_k < 1:
        raise ValueError("flash_attention: window >= 0, block_q and block_k "
                         ">= 1")


def kernel_refusal(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> Optional[str]:
    """Why the CUDA kernel would not take these inputs, or None when it
    would: the dtype, the head dim, the memory, the layout."""
    if q.dtype not in _DTYPE_CODE:
        return f"dtype {q.dtype} (the kernel takes float32 and bfloat16)"
    if q.shape[-1] not in HEAD_DIMS:
        return f"head dim {q.shape[-1]} (the kernel takes {HEAD_DIMS})"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _build.launches_kernel(t):
            return f"{name} in pageable host memory"
        if not t.is_contiguous():
            return f"{name} is not contiguous"
        if t.data_ptr() % 16:
            return f"{name}'s data pointer is not 16-byte aligned"
    return None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    sm_scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q: (B,H,Sq,D); k,v: (B,KVH,Sk,D) -> (B,H,Sq,D).

    Replaces ``repro/kernels/flash_attention.py:flash_attention``.  Bound
    by operations: ``4·D`` a head and admitted (query, key) pair.  On the
    card the kernel is ``INSTANCE[q.dtype]`` (see the notes in the CUDA
    sources).  ``block_q``/``block_k`` keep the reference's signature and
    tile only the plain version: on the card they have no effect, the
    kernels' tiles are their own."""
    _check_args(q, k, v, window, block_q, block_k)
    if not _build.launches_kernel(q):
        counts.PLAIN["flash_attention"] += 1
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       sm_scale=sm_scale, block_q=block_q,
                                       block_k=block_k)
    refusal = kernel_refusal(q, k, v)
    if refusal is not None:
        raise ValueError(f"flash_attention: the kernel does not take {refusal}")
    return run_instance(INSTANCE[q.dtype], q, k, v, causal=causal,
                        window=window, sm_scale=sm_scale)


def run_instance(instance: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, *, causal: bool = True, window: int = 0,
                 sm_scale: Optional[float] = None) -> torch.Tensor:
    """Launches the named kernel on card tensors.  :func:`flash_attention`
    calls it with ``INSTANCE[q.dtype]``; a check calls it by name to hold
    one kernel against the other on the same inputs.  Raises on what the
    kernel does not take, and on a failed launch."""
    if instance not in _ENTRY:
        raise ValueError(f"flash_attention: no instance {instance!r}; "
                         f"there are {sorted(_ENTRY)}")
    source, entry, dtypes = _ENTRY[instance]
    _check_args(q, k, v, window, 1, 1)
    refusal = kernel_refusal(q, k, v)
    if refusal is None and q.dtype not in dtypes:
        refusal = f"dtype {q.dtype} in the {instance} kernel"
    if refusal is not None:
        raise ValueError(f"flash_attention: the kernel does not take {refusal}")
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    # a window of sq or more admits what no window admits; cut to sq it
    # fits the kernel's int
    window = min(window, sq)
    dev = _build.compute_device(q)
    out = _build.empty_like_placed(q)
    fn = _build.bind(source, entry,
                     (_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                      _F, _VP))
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              _DTYPE_CODE[q.dtype], b, h, kvh, sq, sk, d, int(bool(causal)),
              window, float(scale), _build.current_stream(dev))
    _build.check_launch(source, "flash_attention", code)
    counts.LAUNCHES["flash_attention"] += 1
    counts.INSTANCES[f"flash_attention:{instance}"] += 1
    return out
