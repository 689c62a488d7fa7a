"""Port vs reference for flash attention, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package's
Pallas kernel (in interpret mode, as tests/test_kernels.py runs it) and
through the port's plain version of the same online-softmax algorithm,
:func:`repro_torch.kernels.ref.flash_attention_ref`, which the port's
wrapper takes for a CPU tensor.  The CUDA kernel runs only on the card:
tests/test_torch_cuda.py and chip_smoke.py hold it against the same plain
version there.

Tolerances are the reference's own: 2e-5 for float32 against the dense
oracle and between the two packages, 2e-2 for bfloat16 (8 mantissa bits),
1e-5 between tilings (the sums over KV blocks are grouped differently).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jflash
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import counts, flash_attention, ops, ref

I = dict(interpret=True)
F32_ATOL, BF16_ATOL, TILING_ATOL = 2e-5, 2e-2, 1e-5


def _qkv(b, h, kvh, sq, sk, d, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for shape in ((b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d))]


def _both(arrays, dtype="float32"):
    """The same inputs for each package, rounded to ``dtype`` by each."""
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return j, t


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# the reference's six CASES: b, h, kvh, s, d, causal, window
CASES = [
    (1, 1, 1, 128, 64, True, 0),
    (2, 4, 2, 256, 64, True, 0),       # GQA
    (1, 4, 1, 256, 128, True, 0),      # MQA
    (1, 2, 2, 256, 64, False, 0),      # bidirectional
    (1, 4, 2, 512, 64, True, 128),     # sliding window
    (2, 2, 1, 256, 32, True, 64),      # window + GQA + small head
]


@pytest.mark.parametrize("b,h,kvh,s,d,causal,window", CASES)
def test_flash_ref_matches_the_reference_kernel(b, h, kvh, s, d, causal,
                                                window):
    (jq, jk, jv), (q, k, v) = _both(_qkv(b, h, kvh, s, s, d, seed=1))
    want = jflash.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  block_q=128, block_k=128, **I)
    got = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                  block_q=128, block_k=128)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    dense = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(dense), atol=F32_ATOL)


@pytest.mark.parametrize("b,h,kvh,s,d,causal,window", CASES)
def test_dense_oracle_matches_the_reference_oracle(b, h, kvh, s, d, causal,
                                                   window):
    (jq, jk, jv), (q, k, v) = _both(_qkv(b, h, kvh, s, s, d, seed=2))
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    got = ref.attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0)])
def test_flash_ref_bf16_matches_the_reference_kernel(causal, window):
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, 2, 1, 256, 256, 64, seed=3),
                                    "bfloat16")
    want = jflash.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  **I)
    got = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=BF16_ATOL)
    dense = ref.attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(dense), atol=BF16_ATOL)


TILINGS = [(128, 128), (256, 128), (128, 256), (512, 512), (96, 160),
           (200, 200)]


@pytest.mark.parametrize("block_q,block_k", TILINGS)
def test_flash_ref_does_not_depend_on_the_tiling(block_q, block_k):
    """At each tiling the port agrees with the reference at the same
    tiling, and with itself at (128, 128) — also where the sequence does
    not divide the block (a ragged KV tail)."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, 2, 2, 512, 512, 64, seed=4,
                                         scale=0.3))
    base = ref.flash_attention_ref(q, k, v, causal=True)
    got = ref.flash_attention_ref(q, k, v, causal=True, block_q=block_q,
                                  block_k=block_k)
    want = jflash.flash_attention(jq, jk, jv, causal=True, block_q=block_q,
                                  block_k=block_k, **I)
    np.testing.assert_allclose(got.numpy(), base.numpy(), atol=TILING_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TILING_ATOL)


@pytest.mark.parametrize("s,causal,window", [(192, True, 0), (320, True, 64),
                                             (160, False, 0)])
def test_flash_ref_ragged_sequence(s, causal, window):
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, 2, 2, s, s, 64, seed=5))
    want = jflash.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  **I)
    got = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    np.testing.assert_allclose(
        got.numpy(), ref.attention_ref(q, k, v, causal=causal,
                                       window=window).numpy(), atol=F32_ATOL)


@pytest.mark.parametrize("s,causal,window", [(256, True, 0), (320, True, 64)])
def test_flash_ref_head_dim_256_peaked(s, causal, window):
    """gemma3's head dim, with q and k drawn so that the scores have a std
    of 3 and each row's softmax is peaked: a key left out of the sum would
    show in the output."""
    arrays = _qkv(1, 4, 1, s, s, 256, seed=8, scale=3.0 ** 0.5)
    arrays[2] *= 0.5 / 3.0 ** 0.5
    (jq, jk, jv), (q, k, v) = _both(arrays)
    want = jflash.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  **I)
    got = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    np.testing.assert_allclose(
        got.numpy(), ref.attention_ref(q, k, v, causal=causal,
                                       window=window).numpy(), atol=F32_ATOL)


@pytest.mark.parametrize("sq,sk,causal,window", [(200, 328, True, 0),
                                                 (328, 200, True, 0),
                                                 (160, 96, False, 48)])
def test_flash_ref_sq_differs_from_sk(sq, sk, causal, window):
    """Causal and window positions both count from 0 (top-left), in both
    packages, when Sq != Sk."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, 4, 2, sq, sk, 64, seed=6))
    want = jflash.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  block_q=64, block_k=64, **I)
    got = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                  block_q=64, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


def test_rows_with_no_admissible_key_are_zero():
    """Non-causal, window 8, 16 keys: rows from 16 - 1 + 8 = 23 on admit no
    key.  Both packages return 0 there (they divide by 1 where l == 0);
    the dense oracle returns the mean of v instead."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, 2, 1, 64, 16, 32, seed=7))
    want = np.asarray(jflash.flash_attention(
        jq, jk, jv, causal=False, window=8, block_q=16, block_k=16, **I))
    got = ref.flash_attention_ref(q, k, v, causal=False, window=8,
                                  block_q=16, block_k=16).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL)
    assert not np.abs(got[:, :, 23:]).any() and not np.abs(want[:, :, 23:]).any()
    assert np.abs(got[:, :, :23]).min() > 0
    dense = ref.attention_ref(q, k, v, causal=False, window=8).numpy()
    np.testing.assert_allclose(dense[:, :, 23:],
                               np.broadcast_to(v.numpy().mean(axis=2,
                                                              keepdims=True),
                                               dense[:, :, 23:].shape),
                               atol=1e-6)


def test_entry_points_match_across_packages():
    """The slice as a whole: the kernels package's public entry point of
    each package on the same inputs (the port's on CPU tensors, counted
    as plain)."""
    counts.reset()
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, 4, 2, 256, 256, 32, seed=8))
    want = jops.flash_attention(jq, jk, jv, causal=True, window=64,
                                block_q=64, block_k=128)
    got = ops.flash_attention(q, k, v, causal=True, window=64, block_q=64,
                              block_k=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    got = ops.flash_attention(q, k, v, causal=False, sm_scale=0.1)
    want = jops.flash_attention(jq, jk, jv, causal=False, sm_scale=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    launched, plain = counts.snapshot()
    assert plain["flash_attention"] == 2 and not any(launched.values())


@pytest.mark.parametrize("shapes,error", [
    (((1, 2, 64, 32), (1, 1, 64, 32), (1, 1, 64)), ValueError),
    (((2, 64, 32), (1, 64, 32), (1, 64, 32)), ValueError),
    (((1, 3, 64, 32), (1, 2, 64, 32), (1, 2, 64, 32)), ValueError),
    (((1, 2, 64, 32), (1, 1, 64, 16), (1, 1, 64, 16)), ValueError),
    (((2, 2, 64, 32), (1, 1, 64, 32), (1, 1, 64, 32)), ValueError),
    (((1, 2, 64, 32), (1, 1, 64, 32), (1, 1, 32, 32)), ValueError),
    (((1, 2, 0, 32), (1, 1, 64, 32), (1, 1, 64, 32)), ValueError),
])
def test_wrapper_refuses_bad_shapes_before_the_device(shapes, error):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(error):
        flash_attention.flash_attention(q, k, v)


def test_wrapper_refuses_bad_arguments():
    q, k, v = (torch.zeros(s) for s in ((1, 2, 64, 32), (1, 1, 64, 32),
                                        (1, 1, 64, 32)))
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q, k.double(), v)
    for kw in (dict(window=-1), dict(block_q=0), dict(block_k=0)):
        with pytest.raises(ValueError):
            flash_attention.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("d,dtype,refused", [
    (96, torch.float32, "head dim 96"),
    (48, torch.bfloat16, "head dim 48"),
    (64, torch.float16, "dtype"),
    (64, torch.float64, "dtype"),
])
def test_kernel_refuses_what_it_does_not_take(d, dtype, refused):
    """The kernel's own check, a plain function: on a CUDA tensor the
    wrapper raises with its reason instead of taking the plain version.
    On the CPU the plain version takes these inputs."""
    q, k, v = (torch.zeros(s, dtype=dtype) for s in
               ((1, 2, 64, d), (1, 1, 64, d), (1, 1, 64, d)))
    assert refused in flash_attention.kernel_refusal(q, k, v)
    counts.reset()
    out = flash_attention.flash_attention(q, k, v)
    assert out.shape == q.shape and out.dtype == dtype
    assert counts.PLAIN["flash_attention"] == 1


@pytest.mark.parametrize("d", flash_attention.HEAD_DIMS)
def test_kernel_head_dims_cover_every_config(d):
    from repro_torch.configs import ALL_ARCHS, get_config
    dims = {get_config(a).head_dim for a in ALL_ARCHS
            if get_config(a).n_heads} | {get_config(a).reduced().head_dim
                                         for a in ALL_ARCHS
                                         if get_config(a).n_heads}
    assert dims <= set(flash_attention.HEAD_DIMS)
    q, k, v = (torch.zeros(s) for s in ((1, 2, 64, d), (1, 1, 64, d),
                                        (1, 1, 64, d)))
    # on the CPU only the memory stands in the way: pageable host tensors
    assert flash_attention.kernel_refusal(q, k, v) == \
        "q in pageable host memory"


def test_the_dtype_picks_the_kernel_by_a_fixed_table():
    """bfloat16 runs the tensor-core kernel, float32 the FMA kernel: one
    entry each, both sources in the build, nothing else to fall back to."""
    from repro_torch.kernels import _build
    assert flash_attention.INSTANCE == {torch.bfloat16: "wgmma_bf16",
                                        torch.float32: "fma_f32"}
    entry = flash_attention._ENTRY
    assert entry["wgmma_bf16"][:2] == ("flash_attention_tc",
                                       "repro_flash_attention_tc")
    assert entry["fma_f32"][:2] == ("flash_attention",
                                    "repro_flash_attention")
    assert entry["wgmma_bf16"][2] == (torch.bfloat16,)
    assert set(flash_attention.INSTANCE.values()) == set(entry)
    assert {e[0] for e in entry.values()} <= set(_build.SOURCES)
    assert set(counts.INSTANCES) == {f"flash_attention:{i}" for i in entry}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
@pytest.mark.parametrize("d", [8, 16, 32, 48, 64, 96, 128, 256, 512])
def test_kernel_refusal_is_unchanged_for_every_head_dim_and_dtype(d, dtype):
    """The same reasons as before the tensor-core kernel: the dtype first,
    then the head dim, then (here, on the CPU) the memory."""
    q, k, v = (torch.zeros(s, dtype=dtype) for s in
               ((1, 2, 64, d), (1, 1, 64, d), (1, 1, 64, d)))
    got = flash_attention.kernel_refusal(q, k, v)
    if dtype not in (torch.float32, torch.bfloat16):
        assert got == f"dtype {dtype} (the kernel takes float32 and bfloat16)"
    elif d not in (16, 32, 64, 128, 256):
        assert got == f"head dim {d} (the kernel takes (16, 32, 64, 128, 256))"
    else:
        assert got == "q in pageable host memory"


def test_run_instance_refuses_before_the_device():
    q, k, v = (torch.zeros(s, dtype=torch.bfloat16) for s in
               ((1, 2, 64, 64), (1, 1, 64, 64), (1, 1, 64, 64)))
    counts.reset()
    with pytest.raises(ValueError, match="no instance"):
        flash_attention.run_instance("tf32", q, k, v)
    with pytest.raises(ValueError, match="pageable host memory"):
        flash_attention.run_instance("wgmma_bf16", q, k, v)
    assert not any(counts.LAUNCHES.values()) and not any(counts.PLAIN.values())
    assert not any(counts.INSTANCES.values())
