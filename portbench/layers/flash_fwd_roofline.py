"""Attention kernel: the flash forward's least time from its shapes
(``work/flash.py``: each input read once, each output written once,
``4·D`` FLOPs a head and admitted pair, at 989 TFLOP/s and 3.35 TB/s)
over its device time, in the traced segment.  One launch a layer and
request: a count that differs reads nothing."""
from portbench.work import flash

KERNEL = "flash_tc_kernel"


def read(run):
    t = run.trace
    if t is None or not t.device_ops or run.kind != "serve":
        return None
    cfg, mix = run.config, run.traffic
    launches = t.count(KERNEL)
    calls = cfg["num_hidden_layers"] * mix["trace_requests"]
    if launches != calls:
        return None
    least = flash.least_seconds(flash.forward(
        mix["batch"], cfg["num_attention_heads"],
        cfg["num_key_value_heads"], mix["prompt_len"], cfg["head_dim"]))
    return 100.0 * calls * least / (t.device_us(name_has=KERNEL) / 1e6)
