"""Train step: host syncs a step, as PyTorch's sync debug mode reports
them, in the traced steps."""


def read(run):
    syncs = run.counts.get("step")
    if not syncs or run.trace is None or not run.trace.device_ops:
        return None
    return sum(syncs) / len(syncs)
