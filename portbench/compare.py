"""The numbers the check compares, and the rule that leaves leaves out.

Served tokens (greedy): by how much each served token's reference logit
lies below the reference's best, and each sequence's RMS error of the
served logits against the reference's, over the RMS of the reference's;
their widest, mean and median over the sample.  Training: each checked step's loss against the
reference's (relative), and by the worst leaf the gap between the
program's norm and the reference's of the first clipped gradient and of
the change over the checked steps, over the reference's norm of that leaf
or of the median leaf, whichever is larger.  Leaves whose reference
gradient is under a thousandth of the median leaf's are left out.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import torch

NEGLIGIBLE = 1e-3


def served_rows(ref_logits: torch.Tensor, logits: torch.Tensor,
                tokens: torch.Tensor, vocab: int):
    """ref_logits, logits: (B, >= vocab); tokens: (B,) the served ids ->
    (gap, rel), each (B,) float32: by how much each served token's
    reference logit lies below the reference's best (a token outside the
    vocabulary: inf), and the RMS error of each row's logits over the RMS
    of the reference's."""
    r = ref_logits[:, :vocab].float()
    p = logits[:, :vocab].float().to(r.device)
    tok = tokens.to(r.device).long()
    picked = r.gather(1, tok.clamp(max=vocab - 1)[:, None])[:, 0]
    gap = r.max(dim=1).values - picked
    gap = torch.where(tok >= vocab, torch.full_like(gap, float("inf")), gap)
    rel = (p - r).pow(2).mean(1).sqrt() / r.pow(2).mean(1).sqrt()
    return gap, rel


def served(gap: torch.Tensor, rel: torch.Tensor) -> Dict[str, float]:
    """The numbers over a sample's served tokens (``served_rows`` of each
    request, joined): ``token_gap`` the widest gap, ``token_gap_mean``
    the mean gap, ``token_miss`` the share not the reference's best,
    ``logits_rel_rms`` the worst row's error and ``logits_rel_rms_median``
    the median row's."""
    gap, rel = gap.double(), rel.double()
    return {"token_gap": float(gap.max()),
            "token_gap_mean": float(gap.mean()),
            "token_miss": float((gap > 0).double().mean()),
            "logits_rel_rms": float(rel.max()),
            "logits_rel_rms_median": float(rel.median())}


def leaves_kept(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= NEGLIGIBLE * med]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> Dict[str, float]:
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


def training(prog: dict, ref: dict) -> Dict[str, float]:
    """prog, ref: {"loss": [...], "grad": {leaf: norm}, "change": {leaf:
    norm}} -> {"loss_gap" (reported, not compared: see PERF.md),
    "grad_gap", "change_gap", and the leaf each of these two is worst
    at}."""
    keep = leaves_kept(ref["grad"])
    out = {"loss_gap": max(abs(a - b) / abs(b)
                           for a, b in zip(prog["loss"], ref["loss"])),
           "leaves_kept": f"{len(keep)} of {len(ref['grad'])}"}
    for name in ("grad", "change"):
        gaps = leaf_gaps(prog[name], ref[name], keep)
        worst = max(gaps, key=gaps.get)
        out[f"{name}_gap"] = gaps[worst]
        out[f"{name}_worst_leaf"] = worst
    return out


def leaf_norms(name: str, t: torch.Tensor, layered: bool) -> Dict[str, float]:
    """{leaf: float32 norm}; a ``layered`` leaf (stacked over the layers)
    is cut into one leaf a layer, ``<name>.<i>``."""
    if not layered:
        return {name: float(torch.linalg.vector_norm(t.float()))}
    norms = torch.linalg.vector_norm(t.float().reshape(t.shape[0], -1),
                                     dim=1).tolist()
    return {f"{name}.{i}": n for i, n in enumerate(norms)}
