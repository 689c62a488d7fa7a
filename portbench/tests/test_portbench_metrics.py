"""The readers on synthetic windows and traces, and the yardstick's
FLOPs and bytes against hand counts at the cells' shapes."""
import json

import pytest

from portbench import harness
from portbench.trace import Trace
from portbench.work import flash, moe_decoder, mamba2, peaks

OLMOE = json.loads((harness.HERE / "configs/olmoe-1b-7b.json").read_text())
MAMBA = json.loads((harness.HERE / "configs/mamba2-370m.json").read_text())


def _serve_window(service, n, rate, stall_at=None, stall=0.0, seconds=10.0):
    """Requests of 2 x 3840 due every 1/rate s, each served in
    ``service`` s once due and the engine free; one stall of ``stall`` s
    before request ``stall_at``."""
    rec = harness.RunRecord(kind="serve", config=OLMOE,
                            traffic={"batch": 2})
    free = 0.0
    for i in range(n):
        due = i / rate
        start = max(due, free) + (stall if i == stall_at else 0.0)
        if start >= seconds:
            break
        free = start + service
        rec.requests.append({"due": due, "start": start, "done": free,
                             "seqs": 2, "tokens": 7680, "index": i})
    rec.window_s = max(seconds, free)
    return rec


@pytest.mark.parametrize("rate", [4.0, 10.0])
def test_a_stall_moves_throughput_and_tail(rate):
    rd = harness.load_module("e2e", "prefill_tokens_per_s").read
    tail = harness.load_module("e2e", "ttft_p95_ms").read
    calm = _serve_window(0.19, 400, rate)
    hit = _serve_window(0.19, 400, rate, stall_at=10, stall=2.0)
    assert rd(hit) < rd(calm)
    assert tail(hit) > tail(calm)
    if rate == 4.0:            # below capacity: each waits its service
        assert tail(calm) == pytest.approx(190.0)
    else:                      # above: every request served back to back
        assert rd(calm) == pytest.approx(7680 / 0.19, rel=0.02)


def test_train_rate_and_mfu():
    rec = harness.RunRecord(kind="train", config=MAMBA, traffic={})
    flops = mamba2.train_flops(MAMBA, 4, 4096)
    rec.steps = [{"start": 2.5 * i, "done": 2.5 * (i + 1), "tokens": 16384,
                  "flops": flops} for i in range(20)]
    rec.window_s = 50.0
    assert harness.load_module("e2e", "train_tokens_per_s").read(rec) == \
        pytest.approx(16384 / 2.5)
    mfu = harness.load_module("layers", "mfu.train").read(rec)
    assert mfu == pytest.approx(100 * flops / 2.5 / peaks.BF16_FLOPS)


def test_olmoe_prefill_flops_by_hand():
    # per token and layer: q, k, v, o 4·2048·2048; router 2048·64;
    # 8 experts x 3 x 2048·1024; attention 4·128·16 a pair
    per_tok = 2 * (4 * 2048 * 2048 + 2048 * 64 + 8 * 3 * 2048 * 1024)
    pairs = 3840 * 3841 // 2
    attn = 4 * 128 * 16 * 2 * pairs
    want = 16 * (7680 * per_tok + attn) + 2 * 2 * 2048 * 50432
    assert moe_decoder.prefill_flops(OLMOE, 2, 3840) == want


def test_mamba2_train_flops_by_hand():
    d, di, n, p, q, nh = 1024, 2048, 128, 64, 256, 32
    layer = (2 * d * (2 * di + 2 * n + nh) + 2 * 4 * (di + 2 * n)
             + 2 * (q + 1) / 2 * n + nh * (2 * (q + 1) / 2 * p
                                          + 4 * n * p) + 2 * di * d)
    fwd = 48 * layer + 2 * d * 50432
    assert mamba2.train_flops(MAMBA, 4, 4096) == pytest.approx(
        3 * 4 * 4096 * fwd)


def test_flash_least_work_by_hand():
    w = flash.forward(2, 16, 16, 3840, 128)
    assert w["flops"] == 4 * 128 * 16 * 2 * (3840 * 3841 // 2)
    assert w["bytes"] == 2 * 2 * 3840 * 128 * (16 + 16 + 16 + 16)
    assert flash.least_seconds(w) == pytest.approx(w["flops"] / 989e12)
    assert flash.admitted_pairs(8) == 36


def _trace():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.traced",
           "ts": 0, "dur": 100}]

    def kernel(name, ts, dur, corr, launch, rng=None):
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                   "dur": dur, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": launch, "dur": 1,
                   "args": {"correlation": corr}})

    ev.append({"ph": "X", "cat": "user_annotation",
               "name": "portbench.prefill", "ts": 0, "dur": 90})
    ev.append({"ph": "X", "cat": "user_annotation",
               "name": "portbench.moe_apply", "ts": 20, "dur": 30})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 25,
               "dur": 5})
    kernel("gemm", 10, 20, 1, 5)          # launched in prefill
    kernel("gemm", 30, 10, 2, 26)         # in moe_apply, after the op mm
    kernel("flash_tc_kernel<128>", 60, 20, 3, 55)
    return Trace(ev)


def test_trace_busy_attribution_and_gaps():
    t = _trace()
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(50e-6)           # 10..40, 60..80
    assert t.device_us("prefill") == 50
    assert t.device_us("moe_apply") == 10
    assert t.device_us(name_has="flash_tc_kernel") == 20
    b = t.breakdown()
    assert b["device_ops"][0] == ["gemm", pytest.approx(30e-6)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps["prefill/-"] == pytest.approx(30e-6)   # 0..10 and 40..60
    assert gaps["after the last operation"] == pytest.approx(20e-6)
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)
