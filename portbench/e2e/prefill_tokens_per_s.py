"""Prompt tokens of every request served in the window, over the whole
window (from its start to its last request's end)."""


def read(run):
    if run.kind != "serve" or not run.requests:
        return None
    return sum(r["tokens"] for r in run.requests) / run.window_s
