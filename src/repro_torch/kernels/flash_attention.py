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

The gradient: where grad is enabled and q, k or v requires it,
:func:`flash_attention` goes through :class:`FlashAttentionFn`.  Its
forward runs the same kernel with the rows' log-sum-exp as a second
output; its backward (:func:`flash_attention_bwd`) recomputes the scores
from q, k, v, o and the log-sum-exp in the kernel of another fixed table,
:data:`BWD_INSTANCE`: bfloat16 goes to ``csrc/flash_attention_bwd_tc.cu``
(``wgmma_bf16``: every product on the tensor cores, p and ds as two bf16
terms), float32 to ``csrc/flash_attention_bwd.cu`` (``fma_f32``, float32
FMAs).  That source is built for bfloat16 too (``fma_bf16``), which only a
check launches by name (:func:`run_bwd_instance`).  The reference has no
backward kernel (its gradient of attention is XLA's autodiff of jnp);
this is the gradient of the port's forward kernels' exact function.  On
CPU tensors the same Function runs the plain forward and
:func:`ref.flash_attention_bwd_ref`, the backward's algorithm in plain
torch.

On ``meta`` tensors (the dry-run, :mod:`repro_torch.launch.dryrun`) every
entry point models the card's launch: the card's checks first
(:func:`_check_args`, :func:`kernel_refusal`, which raises as it would on
the card), then ``meta`` outputs of the card route's shapes and dtypes,
every tensor the card route allocates allocated (the float32 log-sum-exp,
the backward's outputs and its rows' scratch), and the card's counted work
reported through ``counts.modelled``: never a launch, never a plain call.
Any device but the CPU, the card (or pinned host memory) and ``meta``
raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
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
# the backward kernel each dtype runs on the card: a fixed table, not a
# fallback; instance -> (source under csrc/, C entry point, dtypes it
# takes).  The FMA source is built for bfloat16 too (``fma_bf16``), so that
# a check can hold the tensor-core kernel against it on the same inputs.
BWD_INSTANCE = {torch.bfloat16: "wgmma_bf16", torch.float32: "fma_f32"}
_BWD_ENTRY = {"wgmma_bf16": ("flash_attention_bwd_tc",
                             "repro_flash_attention_bwd_tc",
                             (torch.bfloat16,)),
              "fma_f32": ("flash_attention_bwd", "repro_flash_attention_bwd",
                          (torch.float32,)),
              "fma_bf16": ("flash_attention_bwd", "repro_flash_attention_bwd",
                           (torch.bfloat16,))}

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the backward kernel's rows of scratch are padded to this (see
# ``repro_flash_attention_bwd_tc_scratch``)
_BWD_PAD_ROWS = 128


# a launch's refusal of ``meta`` tensors, which only the entry points model
META_REFUSAL = "meta tensors: a launch takes the card's"


def modelled(t: torch.Tensor) -> bool:
    """True for a ``meta`` tensor: the call models the card's launch."""
    return t.device.type == "meta"


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


@functools.lru_cache(maxsize=256)
def admitted_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the masks admit, positions from 0."""
    qp = np.arange(sq)
    hi = np.minimum(sk, qp + 1) if causal else np.full(sq, sk)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(0, hi - lo).sum())


def forward_work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: int,
                 lse: bool = False) -> counts.Work:
    """The forward's counted work: ``4·D`` operations a head and admitted
    pair (the two products), q, k and v read once, the output written
    once, and the float32 log-sum-exp where the call writes one."""
    b, h, sq, d = q.shape
    pairs = admitted_pairs(sq, k.shape[2], bool(causal), min(window, sq))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return counts.Work(4 * d * h * b * pairs,
                       nbytes + (b * h * sq * 4 if lse else 0))


def backward_work(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, *, causal: bool,
                  window: int) -> counts.Work:
    """The backward's counted work: ``10·D`` operations a head and
    admitted pair (the five products; the tensor-core kernel executes
    more, see ``csrc/flash_attention_bwd_tc.cu``), q, k, v, o, do and the
    log-sum-exp read once, dq, dk and dv written once."""
    b, h, sq, d = q.shape
    pairs = admitted_pairs(sq, k.shape[2], bool(causal), min(window, sq))
    nbytes = (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) \
        * q.element_size()
    return counts.Work(10 * d * h * b * pairs, nbytes + b * h * sq * 4)


def kernel_refusal(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> Optional[str]:
    """Why the CUDA kernel would not take these inputs, or None when it
    would: the dtype, the head dim, the memory, the layout."""
    if q.dtype not in _DTYPE_CODE:
        return f"dtype {q.dtype} (the kernel takes float32 and bfloat16)"
    if q.shape[-1] not in HEAD_DIMS:
        return f"head dim {q.shape[-1]} (the kernel takes {HEAD_DIMS})"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not modelled(t) and not _build.launches_kernel(t):
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
    kernels' tiles are their own.  Where grad is enabled and q, k or v
    requires it, the call goes through :class:`FlashAttentionFn`, whose
    backward is the backward kernel (the plain one on CPU tensors)."""
    _check_args(q, k, v, window, block_q, block_k)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, sm_scale,
                                      block_q, block_k)
    if not modelled(q) and not _build.launches_kernel(q):
        with counts.plain("flash_attention", forward_work(
                q, k, v, causal=causal, window=window)):
            return ref.flash_attention_ref(
                q, k, v, causal=causal, window=window, sm_scale=sm_scale,
                block_q=block_q, block_k=block_k)
    refusal = kernel_refusal(q, k, v)
    if refusal is not None:
        raise ValueError(f"flash_attention: the kernel does not take {refusal}")
    if modelled(q):
        return _model_forward(q, k, v, causal=causal, window=window,
                              lse=False)[0]
    return run_instance(INSTANCE[q.dtype], q, k, v, causal=causal,
                        window=window, sm_scale=sm_scale)


def run_instance(instance: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, *, causal: bool = True, window: int = 0,
                 sm_scale: Optional[float] = None) -> torch.Tensor:
    """Launches the named forward kernel on card tensors: the raw launch,
    with no autograd.  :func:`flash_attention` calls it with
    ``INSTANCE[q.dtype]``; a check calls it by name to hold one kernel
    against the other on the same inputs.  Raises on what the kernel does
    not take and on a failed launch."""
    return _launch_forward(instance, q, k, v, causal=causal, window=window,
                           sm_scale=sm_scale, lse=None)


def _launch_forward(instance: str, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, *, causal: bool, window: int,
                    sm_scale: Optional[float],
                    lse: Optional[torch.Tensor]) -> torch.Tensor:
    """The forward kernel's launch; with ``lse`` (float32 (B, H, Sq) on the
    card) it also writes each row's log-sum-exp there."""
    if instance not in _ENTRY:
        raise ValueError(f"flash_attention: no instance {instance!r}; "
                         f"there are {sorted(_ENTRY)}")
    source, entry, dtypes = _ENTRY[instance]
    _check_args(q, k, v, window, 1, 1)
    refusal = kernel_refusal(q, k, v)
    if refusal is None and q.dtype not in dtypes:
        refusal = f"dtype {q.dtype} in the {instance} kernel"
    if refusal is None and modelled(q):
        refusal = META_REFUSAL
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
                     (_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I,
                      _I, _F, _VP))
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              None if lse is None else lse.data_ptr(),
              _DTYPE_CODE[q.dtype], b, h, kvh, sq, sk, d, int(bool(causal)),
              window, float(scale), _build.current_stream(dev))
    _build.check_launch(source, "flash_attention", code)
    counts.launched("flash_attention", forward_work(
        q, k, v, causal=causal, window=window, lse=lse is not None),
        instance)
    return out


def _model_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: int, lse: bool):
    """The card's forward launch modelled on ``meta`` tensors that
    :func:`kernel_refusal` took: its output (and, with ``lse``, its float32
    log-sum-exp) and its counted work.  Returns (out, lse or None)."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse_t = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
             if lse else None)
    counts.modelled("flash_attention", forward_work(
        q, k, v, causal=causal, window=window, lse=lse), INSTANCE[q.dtype])
    return out, lse_t


# ---------------------------------------------------------------------------
# The gradient
# ---------------------------------------------------------------------------


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its backward kernel.

    The forward runs ``INSTANCE[q.dtype]`` with the log-sum-exp output (on
    CPU tensors the plain version with ``return_lse``) and saves q, k, v,
    the output and the log-sum-exp; the backward makes ``do`` contiguous
    (it arrives transposed from ``models.attention.prefill_attention``) and
    runs :func:`flash_attention_bwd`.  Under ``torch.utils.checkpoint`` the
    forward runs twice (once more in the recompute) and the backward
    once."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale, block_q, block_k):
        if modelled(q) or _build.launches_kernel(q):
            refusal = kernel_refusal(q, k, v)
            if refusal is not None:
                raise ValueError(
                    f"flash_attention: the kernel does not take {refusal}")
            if modelled(q):
                out, lse = _model_forward(q, k, v, causal=causal,
                                          window=window, lse=True)
            else:
                lse = _build.empty_like_placed(q, tuple(q.shape[:3]),
                                               torch.float32)
                out = _launch_forward(INSTANCE[q.dtype], q, k, v,
                                      causal=causal, window=window,
                                      sm_scale=sm_scale, lse=lse)
        else:
            with counts.plain("flash_attention", forward_work(
                    q, k, v, causal=causal, window=window, lse=True)):
                out, lse = ref.flash_attention_ref(
                    q, k, v, causal=causal, window=window,
                    sm_scale=sm_scale, block_q=block_q, block_k=block_k,
                    return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, sm_scale=sm_scale,
                      block_q=block_q, block_k=block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def _check_bwd_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    window: int, block_q: int, block_k: int) -> None:
    """What any caller of the backward must pass, the card or the CPU."""
    _check_args(q, k, v, window, block_q, block_k)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must have q's "
                             f"shape, dtype and device, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")
    if (lse.shape != q.shape[:3] or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError("flash_attention_bwd: lse must be float32 "
                         f"{tuple(q.shape[:3])} on q's device, got "
                         f"{tuple(lse.shape)} {lse.dtype} {lse.device}")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        sm_scale: Optional[float] = None, block_q: int = 128,
                        block_k: int = 128):
    """(dq, dk, dv) of :func:`flash_attention` at ``do``, given its output
    ``o`` and log-sum-exp ``lse`` (float32 (B, H, Sq)).

    On the card: ``BWD_INSTANCE[q.dtype]``, bound by operations, ``10·D``
    a head and admitted pair (see the notes in the CUDA sources); a call
    it does not take, or a failed launch, raises.  On CPU tensors:
    :func:`ref.flash_attention_bwd_ref`, tiled by ``block_q``/``block_k``
    (the kernels' tiles are their own)."""
    _check_bwd_args(q, k, v, o, lse, do, window, block_q, block_k)
    if not modelled(q) and not _build.launches_kernel(q):
        with counts.plain("flash_attention_bwd", backward_work(
                q, k, v, causal=causal, window=window)):
            return ref.flash_attention_bwd_ref(
                q, k, v, o, lse, do, causal=causal, window=window,
                sm_scale=sm_scale, block_q=block_q, block_k=block_k)
    if q.dtype not in BWD_INSTANCE:
        raise ValueError("flash_attention_bwd: the kernel does not take "
                         + kernel_refusal(q, k, v))
    if modelled(q):
        return _model_backward(q, k, v, o, lse, do, causal=causal,
                               window=window)
    return run_bwd_instance(BWD_INSTANCE[q.dtype], q, k, v, o, lse, do,
                            causal=causal, window=window, sm_scale=sm_scale)


def bwd_scratch_floats(instance: str, b: int, h: int, sq: int) -> int:
    """The float32 elements of the rows' scratch the backward ``instance``
    takes for (B, H, Sq): delta (B, H, Sq) for the FMA kernel; lse2 and
    delta, each Sq padded to 128 rows, for the tensor-core kernel (its
    library's ``repro_flash_attention_bwd_tc_scratch``)."""
    if instance == "wgmma_bf16":
        return 2 * b * h * (-(-sq // _BWD_PAD_ROWS) * _BWD_PAD_ROWS)
    return b * h * sq


def _bwd_refusal(instance: str, q, k, v, o, lse, do) -> Optional[str]:
    """Why the backward ``instance`` would not take these inputs (on the
    card or ``meta``), or None when it would."""
    refusal = (f"dtype {q.dtype} in the {instance} kernel"
               if q.dtype not in _BWD_ENTRY[instance][2]
               else kernel_refusal(q, k, v))
    for name, t in (("o", o), ("do", do), ("lse", lse)):
        if refusal is None and ((not modelled(t)
                                 and not _build.launches_kernel(t))
                                or not t.is_contiguous()
                                or t.data_ptr() % 16):
            refusal = f"{name} not contiguous and 16-byte aligned on the card"
    return refusal


def _model_backward(q, k, v, o, lse, do, *, causal: bool, window: int):
    """The card's backward launch modelled on ``meta`` tensors: its
    refusals, dq, dk, dv and the rows' scratch allocated (the scratch
    freed at the return, as the card route's), and its counted work."""
    instance = BWD_INSTANCE[q.dtype]
    refusal = _bwd_refusal(instance, q, k, v, o, lse, do)
    if refusal is not None:
        raise ValueError(
            f"flash_attention_bwd: the kernel does not take {refusal}")
    b, h, sq, _ = q.shape
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    scratch = torch.empty(bwd_scratch_floats(instance, b, h, sq),
                          dtype=torch.float32, device=q.device)
    counts.modelled("flash_attention_bwd", backward_work(
        q, k, v, causal=causal, window=window), instance)
    del scratch
    return dq, dk, dv


def run_bwd_instance(instance: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                     do: torch.Tensor, *, causal: bool = True,
                     window: int = 0, sm_scale: Optional[float] = None):
    """Launches the named backward kernel on card tensors and returns
    (dq, dk, dv).  :func:`flash_attention_bwd` calls it with
    ``BWD_INSTANCE[q.dtype]``; a check calls it by name to hold one kernel
    against the other on the same inputs.  Raises ``ValueError`` on an
    unknown instance, a dtype the instance does not take and what the
    kernels do not take (CPU tensors among them), and on a failed
    launch."""
    if instance not in _BWD_ENTRY:
        raise ValueError(f"flash_attention_bwd: no instance {instance!r}; "
                         f"there are {sorted(_BWD_ENTRY)}")
    source, entry, _ = _BWD_ENTRY[instance]
    _check_bwd_args(q, k, v, o, lse, do, window, 1, 1)
    refusal = _bwd_refusal(instance, q, k, v, o, lse, do)
    if refusal is None and modelled(q):
        refusal = META_REFUSAL
    if refusal is not None:
        raise ValueError(
            f"flash_attention_bwd: the kernel does not take {refusal}")
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    window = min(window, sq)
    dev = _build.compute_device(q)
    dq, dk, dv = (_build.empty_like_placed(t) for t in (q, k, v))
    # the rows' scratch: padded rows of lse and delta for the tensor-core
    # kernel, as its library says; delta (B, H, Sq) for the FMA kernel
    n_scratch = (_build.bind(source, entry + "_scratch", (_I, _I, _I),
                             ctypes.c_longlong)(b, h, sq)
                 if instance == "wgmma_bf16"
                 else bwd_scratch_floats(instance, b, h, sq))
    delta = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    fn = _build.bind(source, entry, (_VP,) * 10 + (_I,) * 9 + (_F, _VP))
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
              dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype], b, h, kvh,
              sq, sk, d, int(bool(causal)), window, float(scale),
              _build.current_stream(dev))
    _build.check_launch(source, "flash_attention_bwd", code)
    counts.launched("flash_attention_bwd", backward_work(
        q, k, v, causal=causal, window=window), instance)
    return dq, dk, dv
