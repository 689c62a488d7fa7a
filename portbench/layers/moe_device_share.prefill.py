"""MoE layer: the device time of the operations launched inside
``moe_apply`` over that of those launched inside the prefill call, in
the traced segment."""


def read(run):
    t = run.host_trace
    if t is None or not t.device_ops:
        return None
    whole = t.device_us("prefill")
    if whole <= 0:
        return None
    return 100.0 * t.device_us("moe_apply") / whole
