"""Tokens of every optimizer step of the window, over the whole window
(from its start to the last step's end)."""


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    return sum(s["tokens"] for s in run.steps) / run.window_s
