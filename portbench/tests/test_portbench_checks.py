"""The check that decides ``correct``, at a size a CPU test holds: the
references agree with themselves across block sizes and with the port
run soundly; the control (float8 products) and every fault the cells can
have come out as not correct."""
import time

import pytest
import torch

from portbench import faults, generator, harness
from portbench.reference import mamba2 as ref_mamba2
from portbench.reference import moe_decoder as ref_moe
from portbench.tests import tiny
from portbench.weights import mamba2 as w_mamba2
from portbench.weights import moe_decoder as w_moe

SERVE = "olmoe-1b-7b.prefill-3840x2"
TRAIN = "mamba2-370m.train-4096x4"


def _run(workload, ctx=None, seed=2 ** 31 + 5):
    cell = tiny.cell(workload)
    return harness.run_cell(cell, seed=seed, seconds=0.3, trace=False,
                            device="cpu", t_start=time.perf_counter(),
                            program_ctx=ctx)


def test_moe_reference_agrees_across_blocks():
    cfg = tiny.cell(SERVE).config
    w = w_moe.make(cfg, 7, "cpu")
    tok = torch.randint(0, cfg["vocab_size"], (2, 24),
                        generator=torch.Generator().manual_seed(3))
    a = ref_moe.last_logits(cfg, w, tok, block=24)
    b = ref_moe.last_logits(cfg, w, tok, block=5)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_mamba2_reference_agrees_across_blocks():
    c = tiny.cell(TRAIN)
    cfg, mix = c.config, c.traffic
    w = w_mamba2.make(cfg, 7, "cpu")
    batches = generator.train_batches(mix, 7, 2, cfg["vocab_size"], "cpu")
    a = ref_mamba2.train(cfg, w, batches, mix["optimizer"], steps=2,
                         block=16)
    b = ref_mamba2.train(cfg, w, batches, mix["optimizer"], steps=2,
                         block=3)
    assert a["loss"] == pytest.approx(b["loss"], rel=1e-6)
    for k in a["grad"]:
        assert a["grad"][k] == pytest.approx(b["grad"][k], rel=1e-4)
        assert a["change"][k] == pytest.approx(b["change"][k], rel=1e-3,
                                               abs=1e-7)


@pytest.mark.parametrize("workload", [SERVE, TRAIN])
def test_a_sound_run_is_correct(workload):
    rec = _run(workload)
    assert harness.correct(rec), rec.checks


@pytest.mark.parametrize("workload,fault", [
    (SERVE, "token_altered"), (TRAIN, "half_batch"),
    (TRAIN, "state_unchanged")])
def test_a_fault_in_the_timed_path_is_not_correct(workload, fault):
    rec = _run(workload, faults.FAULTS[
        tiny.cell(workload).traffic["kind"]][fault])
    assert rec.checks and not harness.correct(rec), rec.checks


@pytest.mark.parametrize("workload", [SERVE, TRAIN])
def test_the_float8_control_is_not_correct(workload):
    cell = tiny.cell(workload)
    readings = faults.control(cell, 2 ** 31 + 9, "cpu")
    assert any(readings[k] > lim for k, lim in cell.limits.items()), readings
