"""MoE layer: host syncs a request inside ``moe_apply``, as PyTorch's
sync debug mode reports them, in the traced segment."""


def read(run):
    syncs = run.counts.get("moe_apply")
    if not syncs or run.trace is None or not run.trace.device_ops:
        return None
    return sum(syncs) / run.traffic["trace_requests"]
