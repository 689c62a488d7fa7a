"""Operations the references share: matrix products at a stated
precision, RMSNorm with a ``(1 + w)`` gain, and the float32 context."""
from __future__ import annotations

import contextlib

import torch

_F8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2,
                                                      57344.0)}


def quantize(t: torch.Tensor, kind: str = "e4m3") -> torch.Tensor:
    """``t`` rounded to float8 with one scale for the whole tensor (its
    largest magnitude onto float8's largest), back in float32."""
    dtype, top = _F8[kind]
    t = t.float()
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` on float8 operands; the backward's products take the
    output's gradient in e5m2 and the saved operands in e4m3."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = quantize(a), quantize(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = quantize(g, "e5m2")
        ga = qg @ qb.transpose(-1, -2)
        if qb.dim() == 2:
            gb = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        else:
            gb = qa.transpose(-1, -2) @ qg
        return ga, gb


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` (``b`` a matrix, or a batch of matrices as ``a``'s) in
    ``precision``: "float32" or "fp8"."""
    if precision == "float32":
        return a @ b
    if precision == "fp8":
        return _Fp8Matmul.apply(a, b)
    raise ValueError(f"unknown precision {precision!r}")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + w)


@contextlib.contextmanager
def float32_matmuls():
    """Matrix products in true float32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
