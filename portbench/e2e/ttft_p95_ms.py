"""The 95th percentile, over every sequence of every request due in the
window, of the time from its request's due time to its first token on
the host (a request that failed counts as taking the whole window)."""
import statistics


def read(run):
    if run.kind != "serve" or not run.requests:
        return None
    ttft = []
    for r in run.requests:
        ttft += [r["done"] - r["due"]] * r["seqs"]
    ttft += [run.window_s] * run.failed * run.traffic["batch"]
    return 1e3 * statistics.quantiles(ttft, n=20, method="inclusive")[18]
