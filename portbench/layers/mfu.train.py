"""The model's share of the card's bf16 peak over the training window:
the model FLOPs of every step in it (forward and backward, not the
recompute; ``work/<family>.py``), over the window's time and 989
TFLOP/s."""
from portbench.work import peaks


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    return 100.0 * sum(r["flops"] for r in run.steps) / (
        run.window_s * peaks.BF16_FLOPS)
