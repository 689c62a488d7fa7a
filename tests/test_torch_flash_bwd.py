"""The flash backward's fixed table of kernels, what the wrapper refuses
before it reaches the card, the build's report of registers and spills,
and the rounding study behind the tensor-core design.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
marked ``cuda``); here every check is about what surrounds them, on the
CPU.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, counts, flash_attention, ref

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "flash_bwd_rounding", os.path.join(ROOT, "tools",
                                           "flash_bwd_rounding.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(dtype, d=64, sq=64, h=2, kvh=1):
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dtype) for s in ((1, h, sq, d), (1, kvh, sq, d),
                                         (1, kvh, sq, d), (1, h, sq, d)))
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True)
    return q, k, v, o, lse, do


def test_the_backward_table_is_fixed():
    """bf16 runs the tensor-core backward, float32 the FMA kernel, for
    every head dim; the FMA source is built for bf16 as a third instance
    that only a check launches."""
    assert flash_attention.BWD_INSTANCE == {torch.bfloat16: "wgmma_bf16",
                                            torch.float32: "fma_f32"}
    entry = flash_attention._BWD_ENTRY
    assert entry["wgmma_bf16"] == ("flash_attention_bwd_tc",
                                   "repro_flash_attention_bwd_tc",
                                   (torch.bfloat16,))
    assert entry["fma_f32"] == ("flash_attention_bwd",
                                "repro_flash_attention_bwd",
                                (torch.float32,))
    assert entry["fma_bf16"] == ("flash_attention_bwd",
                                 "repro_flash_attention_bwd",
                                 (torch.bfloat16,))


def test_every_backward_instance_has_its_count():
    assert {k for k in counts.INSTANCES
            if k.startswith("flash_attention_bwd:")} == {
        "flash_attention_bwd:wgmma_bf16", "flash_attention_bwd:fma_bf16",
        "flash_attention_bwd:fma_f32"}


def test_the_build_names_the_tensor_core_backward():
    """The source is built with the others, and both tensor-core sources
    include the header of helpers they share."""
    assert "flash_attention_bwd_tc" in _build.SOURCES
    assert "flash_attention_bwd" in _build.SOURCES
    for name in ("flash_attention_tc", "flash_attention_bwd_tc"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "flash_tc.cuh"' in src
        assert "extern \"C\"" in src
    src = (_build.CSRC / "flash_attention_bwd_tc.cu").read_text()
    for symbol in ("repro_flash_attention_bwd_tc(",
                   "repro_flash_attention_bwd_tc_scratch(",
                   "repro_error_string("):
        assert symbol in src


@pytest.mark.parametrize("instance,dtype,error", [
    ("tf32", torch.bfloat16, "no instance 'tf32'"),
    ("fma", torch.float32, "no instance 'fma'"),
    ("wgmma_bf16", torch.float32, "dtype torch.float32 in the wgmma_bf16"),
    ("fma_f32", torch.bfloat16, "dtype torch.bfloat16 in the fma_f32"),
    ("fma_bf16", torch.float32, "dtype torch.float32 in the fma_bf16"),
    ("wgmma_bf16", torch.bfloat16, "q in pageable host memory"),
    ("fma_bf16", torch.bfloat16, "q in pageable host memory"),
    ("fma_f32", torch.float32, "q in pageable host memory")])
def test_run_bwd_instance_refuses_before_the_device(instance, dtype, error):
    """An unknown instance, a dtype the instance does not take, and CPU
    tensors (the kernels run only on the card) raise ValueError and count
    nothing."""
    q, k, v, o, lse, do = _inputs(dtype)
    counts.reset()
    with pytest.raises(ValueError, match=error):
        flash_attention.run_bwd_instance(instance, q, k, v, o, lse, do)
    assert not any(counts.LAUNCHES.values())
    assert not any(counts.PLAIN.values())
    assert not any(counts.INSTANCES.values())


@pytest.mark.parametrize("what,error", [
    ("o_shape", "o must have q's shape"),
    ("do_dtype", "do must have q's shape, dtype"),
    ("lse_dtype", "lse must be float32"),
    ("head_dim", "head dim 96")])
def test_run_bwd_instance_checks_its_arguments_first(what, error):
    """Shapes, dtypes and the head dim are refused before the memory."""
    q, k, v, o, lse, do = _inputs(torch.bfloat16,
                                  d=96 if what == "head_dim" else 64)
    if what == "o_shape":
        o = o[:, :, :32]
    elif what == "do_dtype":
        do = do.float()
    elif what == "lse_dtype":
        lse = lse.double()
    counts.reset()
    with pytest.raises(ValueError, match=error):
        flash_attention.run_bwd_instance("wgmma_bf16", q, k, v, o, lse, do)
    assert not any(counts.INSTANCES.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_backward(dtype):
    """The wrapper, given CPU tensors, takes the plain version and counts
    it as such; nothing counts as a launch of either instance."""
    q, k, v, o, lse, do = _inputs(dtype)
    counts.reset()
    got = flash_attention.flash_attention_bwd(q, k, v, o, lse, do)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert counts.PLAIN["flash_attention_bwd"] == 1
    assert not any(counts.INSTANCES.values())


PTXAS_SAMPLE = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z18bwd_dkdv_tc_kernelILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z18bwd_dkdv_tc_kernelILi128EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 242 registers, used 16 barriers
ptxas info    : Compiling entry function '_Z16bwd_dq_tc_kernelILi256EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z16bwd_dq_tc_kernelILi256EEvv
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 16 barriers, 8 bytes cumulative stack size
"""


def test_ptxas_report_is_read_kernel_by_kernel():
    got = _build.parse_ptxas(PTXAS_SAMPLE)
    assert got == {
        "_Z18bwd_dkdv_tc_kernelILi128EEvv": {
            "stack_bytes": 0, "spill_stores": 0, "spill_loads": 0,
            "registers": 242},
        "_Z16bwd_dq_tc_kernelILi256EEvv": {
            "stack_bytes": 8, "spill_stores": 4, "spill_loads": 12,
            "registers": 255}}


def test_ptxas_report_of_nothing_is_empty():
    assert _build.parse_ptxas("") == {}
    assert _build.parse_ptxas("    0 bytes stack frame, 0 bytes spill "
                              "stores, 0 bytes spill loads\n") == {}


def test_ptxas_report_is_read_from_beside_the_library(tmp_path,
                                                      monkeypatch):
    """Every build leaves ptxas' report beside its library; reading it
    compiles nothing."""
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    lib = _build._library_path("flash_attention_bwd_tc")
    lib.write_bytes(b"")
    lib.with_suffix(".ptxas.txt").write_text(PTXAS_SAMPLE)
    got = _build.ptxas_report("flash_attention_bwd_tc")
    assert got == _build.parse_ptxas(PTXAS_SAMPLE)


def test_a_library_without_its_report_is_built_again(tmp_path, monkeypatch):
    """A library whose report is missing counts as not built: without
    nvcc that raises rather than reading nothing."""
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build.compat, "nvcc_path", lambda: None)
    _build._library_path("flash_attention_bwd_tc").write_bytes(b"")
    with pytest.raises(_build.KernelBuildError, match="no nvcc"):
        _build.ptxas_report("flash_attention_bwd_tc")


def test_one_bf16_term_fails_and_two_terms_hold():
    """The reason for the design, at a small size: P and dS in one bf16
    term each move the gradients past one bf16 rounding of the float32
    result; in two terms they land where float32 P and dS do, within
    one."""
    t = _tool().table(seq=256, dim=64, heads=2, seed=0)
    for g in ("dq", "dk", "dv"):
        assert t["p_ds_float32"][g] <= 1.0
        assert t["two_terms"][g] <= 1.0
        assert abs(t["two_terms"][g] - t["p_ds_float32"][g]) < 1e-3
        assert t["one_term"][g] > 1.0
    # each operand needs its own split: P feeds dV, dS feeds dQ and dK
    assert t["p_two_ds_one"]["dv"] <= 1.0 < t["p_two_ds_one"]["dq"]
    assert t["p_one_ds_two"]["dq"] <= 1.0 < t["p_one_ds_two"]["dv"]


def test_the_rounding_study_matches_the_plain_backward():
    """The study's float32 gradients are the plain backward's on the same
    bf16 values (one KV head, causal), so its yardstick is the chip
    check's oracle."""
    tool = _tool()
    q, k, v, do = tool.inputs(128, 32, 3, seed=1)
    dq, dk, dv = tool.gradients(q, k, v, do)
    q4, k4, v4, do4 = q[None], k[None, None], v[None, None], do[None]
    o, lse = ref.flash_attention_ref(q4, k4, v4, return_lse=True)
    o = o.bfloat16().float()
    want = ref.flash_attention_bwd_ref(q4, k4, v4, o, lse, do4)
    for got, w in zip((dq[None], dk[None, None], dv[None, None]), want):
        assert float((got - w).abs().max()) <= 1e-4 * float(w.abs().max())
