"""Train step: the device time of the operations launched inside
``adamw_update``, a step, in the traced steps."""


def read(run):
    t = run.host_trace
    if t is None or not t.device_ops or run.kind != "train":
        return None
    return t.device_us("adamw_update") / 1e3 / run.traffic["trace_steps"]
