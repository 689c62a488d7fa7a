"""Serve engine: a request's ``generate`` wall time (to its first tokens
on the host) less its prefill call's (stamped between two
synchronisations), averaged over the window's requests: the engine's own
host time around the model."""


def read(run):
    spans = [r["done"] - r["start"] - r["prefill_s"] for r in run.requests
             if "prefill_s" in r]
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
