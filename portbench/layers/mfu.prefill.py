"""The model's share of the card's bf16 peak over the serving window: the
model FLOPs of every prefill served in it (``work/<family>.py``, from
shapes), over the window's time and 989 TFLOP/s."""
from portbench.work import peaks


def read(run):
    if run.kind != "serve" or not run.requests:
        return None
    return 100.0 * sum(r["flops"] for r in run.requests) / (
        run.window_s * peaks.BF16_FLOPS)
