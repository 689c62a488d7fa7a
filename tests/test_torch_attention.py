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
import jax
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
    assert {k for k in counts.INSTANCES if k.startswith(
        "flash_attention:")} == {f"flash_attention:{i}" for i in entry}
    # the backward: a table of its own, every source in the build, a count
    # for every instance (the bf16 FMA build too, which only checks launch)
    bwd = flash_attention._BWD_ENTRY
    assert set(flash_attention.BWD_INSTANCE.values()) <= set(bwd)
    assert {e[0] for e in bwd.values()} <= set(_build.SOURCES)
    assert {k for k in counts.INSTANCES if k.startswith(
        "flash_attention_bwd:")} == {f"flash_attention_bwd:{i}" for i in bwd}


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


# ---------------------------------------------------------------------------
# Gradients: the wrapper's autograd Function, whose backward on the CPU is
# the backward kernel's plain version
# ---------------------------------------------------------------------------

# float32 gradients of the online softmax against the dense oracle's, held
# to the forward's own 2e-5 (they differ by about 1e-6 on these inputs)
GRAD_ATOL = F32_ATOL


@pytest.mark.parametrize("b,h,kvh,s,d,causal,window", CASES[:2] + CASES[4:])
def test_plain_path_gradients_match_the_dense_oracle(b, h, kvh, s, d, causal,
                                                     window):
    """q, k and v gradients through the plain flash path against autograd
    through the port's dense oracle and against ``jax.vjp`` of the JAX
    package's."""
    arrays = _qkv(b, h, kvh, s, s, d, seed=7)
    rng = np.random.default_rng(8)
    g = torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32))
    grads = []
    for fn in (lambda q, k, v: ops.flash_attention(
                   q, k, v, causal=causal, window=window, block_q=64,
                   block_k=64),
               lambda q, k, v: ref.attention_ref(q, k, v, causal=causal,
                                                 window=window)):
        qkv = [torch.from_numpy(a).requires_grad_() for a in arrays]
        (fn(*qkv) * g).sum().backward()
        grads.append([t.grad for t in qkv])
    # and the JAX package's dense oracle, differentiated in jnp
    _out, vjp = jax.vjp(lambda q, k, v: jref.attention_ref(
        q, k, v, causal=causal, window=window), *map(jnp.asarray, arrays))
    grads.append([torch.from_numpy(np.array(t)) for t in vjp(jnp.asarray(
        g.numpy()))])
    for got, want, jax_want in zip(*grads):
        assert got is not None
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=GRAD_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(got.numpy(), jax_want.numpy(),
                                   atol=GRAD_ATOL, rtol=0)


# the flash gradients against the reference, held to 1e-5 of the largest
# |grad| (float32; the blockwise sums and the dense ones are grouped
# differently, about 1e-7 of it on these inputs)
GRAD_REL = 1e-5


def _jax_oracle(causal, window, sq, sk):
    """The reference's dense oracle with the flash contract for a row that
    admits no key (0, where the dense softmax over equal scores gives the
    mean of v), so that both are the same function."""
    qp = np.arange(sq)[:, None]
    kp = np.arange(sk)[None, :]
    ok = np.ones((sq, sk), bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    has_key = jnp.asarray(ok.any(1)[None, None, :, None])

    def f(q, k, v):
        out = jref.attention_ref(q, k, v, causal=causal, window=window)
        return jnp.where(has_key, out, 0.0)

    return f


def _flash_grads(arrays, g, **kw):
    """(output, [dq, dk, dv]) of ``ops.flash_attention`` on the CPU, with
    the counts of the path it took."""
    qkv = [torch.from_numpy(a).requires_grad_() for a in arrays]
    counts.reset()
    out = ops.flash_attention(*qkv, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    (out * torch.from_numpy(g)).sum().backward()
    assert counts.PLAIN["flash_attention"] == 1
    assert counts.PLAIN["flash_attention_bwd"] == 1
    assert not any(counts.LAUNCHES.values())
    return out, [t.grad for t in qkv]


GRAD_CASES = (
    [(b, h, kvh, s, s, d, causal, window, 128, 128)
     for b, h, kvh, s, d, causal, window in CASES]
    + [(1, 2, 2, 192, 192, 64, True, 0, 128, 128),       # ragged
       (1, 2, 2, 320, 320, 64, True, 64, 128, 128),      # ragged + window
       (1, 4, 2, 200, 328, 64, True, 0, 128, 128),       # Sq < Sk
       (1, 4, 2, 328, 200, 64, False, 0, 128, 128),      # Sq > Sk
       (1, 2, 1, 64, 16, 32, False, 8, 128, 128),        # rows with no key
       (1, 4, 2, 120, 40, 32, True, 16, 32, 16),         # both, tiled
       (1, 4, 1, 256, 256, 256, True, 0, 128, 128),      # head dim 256
       (1, 4, 1, 320, 320, 256, True, 64, 128, 128)]
    + [(1, 2, 2, 512, 512, 64, True, 0, bq, bk) for bq, bk in TILINGS])


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal,window,bq,bk", GRAD_CASES)
def test_flash_gradients_match_the_reference(b, h, kvh, sq, sk, d, causal,
                                             window, bq, bk):
    """dq, dk, dv through the wrapper's Function (the plain forward and
    ``ref.flash_attention_bwd_ref``) against ``jax.vjp`` of the reference's
    dense oracle, on the same numpy inputs."""
    arrays = _qkv(b, h, kvh, sq, sk, d, seed=11, scale=0.5 if d < 256
                  else 3.0 ** 0.5)
    g = np.random.default_rng(12).standard_normal(
        (b, h, sq, d)).astype(np.float32)
    out, got = _flash_grads(arrays, g, causal=causal, window=window,
                            block_q=bq, block_k=bk)
    jout, vjp = jax.vjp(_jax_oracle(causal, window, sq, sk),
                        *map(jnp.asarray, arrays))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=F32_ATOL, rtol=0)
    for name, t, w in zip("qkv", got, vjp(jnp.asarray(g))):
        w = np.asarray(w)
        assert np.isfinite(t.numpy()).all(), name
        err = float(np.abs(t.numpy() - w).max())
        assert err <= GRAD_REL * float(np.abs(w).max()), (name, err)


def test_rows_with_no_key_get_exactly_zero_gradient():
    """A window with Sq != Sk leaves rows with no admitted key: their
    output is 0 and so is their dq, with no NaN anywhere."""
    arrays = _qkv(1, 2, 1, 64, 16, 32, seed=3)
    g = np.ones((1, 2, 64, 32), np.float32)
    out, (dq, dk, dv) = _flash_grads(arrays, g, causal=False, window=8)
    assert (out.detach()[:, :, 16 - 1 + 8:] == 0).all()
    assert (dq[:, :, 16 - 1 + 8:] == 0).all()
    for t in (dq, dk, dv):
        assert torch.isfinite(t).all()
    _, lse = ref.flash_attention_ref(*map(torch.from_numpy, arrays),
                                     causal=False, window=8,
                                     return_lse=True)
    assert torch.isinf(lse[:, :, 16 - 1 + 8:]).all()
    assert torch.isfinite(lse[:, :, :16 - 1 + 8]).all()


@pytest.mark.parametrize("arch,layer", [("qwen2-1.5b", 0),
                                        ("gemma3-1b", 0),     # local
                                        ("gemma3-1b", 5)])    # global
def test_train_attention_layer_gradients_match_the_reference(arch, layer):
    """``attention_layer(mode="train")``: the gradients of x and of every
    parameter through the port's flash Function against ``jax.grad`` of
    the reference's jnp train attention, from converted weights."""
    from repro.configs.base import get_config as jget_config
    from repro.models import attention as jattn
    from repro.models import lm as jlm
    from repro_torch.configs import get_config
    from repro_torch.models import attention, convert
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    key, r = ("p0", layer) if "p0" in jp["scan"] and len(jp["scan"]) == 1 \
        else (f"p{layer % len(jp['scan'])}", layer // len(jp["scan"]))
    jl = jax.tree.map(lambda a: np.asarray(a[r]), jp["scan"][key]["attn"])
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 24, cfg.d_model)) * 0.5).astype(np.float32)
    g = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        y, _ = jattn.attention_layer(p, xx, cfg=jcfg, layer_idx=layer,
                                     mode="train", q_chunk=8)
        return jnp.sum(y * g)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, jl), jnp.asarray(x))
    tl = {k: t.requires_grad_() for k, t in
          convert.params_from_numpy(jl, "cpu").items()}
    tx = torch.from_numpy(x).requires_grad_()
    counts.reset()
    y, _ = attention.attention_layer(tl, tx, cfg=cfg, layer_idx=layer,
                                     mode="train", q_chunk=8)
    (y * torch.from_numpy(g)).sum().backward()
    assert counts.PLAIN["flash_attention_bwd"] == 1
    pairs = [("x", tx.grad, jgx)] + [(k, tl[k].grad, jgp[k]) for k in jl]
    for name, got, want in pairs:
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= GRAD_REL * float(np.abs(want).max()), (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,sq,sk,kvh", [
    (True, 0, 96, 96, 2), (True, 24, 96, 96, 1), (False, 0, 70, 50, 2),
    (False, 8, 60, 16, 1)])
def test_backward_alone_matches_autograd_of_the_dense_oracle(
        dtype, causal, window, sq, sk, kvh):
    """``flash_attention_bwd_ref`` given the forward's output and
    log-sum-exp, against autograd through the port's dense oracle on the
    same values in float32 (rows with no key masked to 0 as the flash
    contract says): float32 within 1e-5 of max |grad|.  bf16 inputs: the
    backward computes in float32 and rounds once, so dv is within one bf16
    rounding of the float32 gradient (2^-7 |want| + 2^-12 max |want|);
    the output it is given is bf16, rounded once, and delta = rowsum(do o)
    carries that rounding into ds where dP and delta nearly cancel, so dq
    and dk (and dv) are held by a normalised error of one rounding,
    ||got - want|| / ||want|| <= 2^-8."""
    b, h, d = 2, 4, 32
    arrays = _qkv(b, h, kvh, sq, sk, d, seed=5)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    do = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (b, h, sq, d)).astype(np.float32)).to(dtype)
    o, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     block_q=32, block_k=16, return_lse=True)
    got = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                      window=window, block_q=32, block_k=16)
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    has_key = torch.isfinite(lse)[..., None]
    dense = torch.where(has_key, ref.attention_ref(
        qf, kf, vf, causal=causal, window=window), 0.0)
    want = torch.autograd.grad(dense, (qf, kf, vf), do.float())
    for name, t, w in zip("qkv", got, want):
        assert t.dtype == dtype
        top = float(w.abs().max())
        d_ = (t.float() - w).abs()
        if dtype == torch.float32:
            assert float(d_.max()) <= GRAD_REL * top, name
            continue
        assert float(d_.norm() / w.norm()) <= 2.0 ** -8, name
        if name == "v":
            assert float((d_ / (2.0 ** -7 * w.abs()
                                + 2.0 ** -12 * top)).max()) <= 1.0


def test_the_function_runs_only_where_a_gradient_is_wanted():
    """Without grad (or with inputs that need none) the wrapper takes the
    plain forward alone: no Function, no log-sum-exp, no backward."""
    arrays = _qkv(1, 2, 1, 64, 64, 32, seed=9)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    counts.reset()
    out = ops.flash_attention(q, k, v)
    assert out.grad_fn is None
    with torch.no_grad():
        out = ops.flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is None
    assert counts.PLAIN["flash_attention"] == 2
    assert counts.PLAIN["flash_attention_bwd"] == 0


@pytest.mark.parametrize("what,error", [
    ("o_shape", "o must have q's shape"),
    ("do_dtype", "do must have q's shape, dtype"),
    ("lse_shape", "lse must be float32"),
    ("lse_dtype", "lse must be float32")])
def test_the_backward_refuses_bad_arguments_before_the_device(what, error):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 64, 64, 32))
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True)
    do = torch.ones_like(o)
    if what == "o_shape":
        o = o[:, :, :32]
    elif what == "do_dtype":
        do = do.double()
    elif what == "lse_shape":
        lse = lse[..., None]
    else:
        lse = lse.double()
    counts.reset()
    with pytest.raises(ValueError, match=error):
        flash_attention.flash_attention_bwd(q, k, v, o, lse, do)
    assert not any(counts.PLAIN.values())
