"""Device: the share of the traced segment (back-to-back requests) in
which nothing ran on the card."""


def read(run):
    t = run.trace
    if t is None or not t.device_ops or run.kind != "serve" or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
