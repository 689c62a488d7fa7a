"""Port vs reference, kernel by kernel, on the CPU.

The same numpy input goes through the JAX package's Pallas kernel (in
interpret mode, as tests/test_kernels.py runs it) and through the port's
wrapper, which on a CPU tensor takes its plain PyTorch version.  The CUDA
kernels themselves run only on the card: chip_smoke.py holds them against
the same plain versions there.

Tolerances: chases, writes, copy and float32 rmw are exact.  A read is a
float32 sum taken in another order by each side: rtol 2e-6, the
reference's own, on inputs with a mean well away from zero so that the
relative tolerance means something.  bf16 rmw: rtol 1e-2 (8 mantissa
bits), the reference's own.  The compute probe: rtol 1e-6 on the
reference's case (powers of 0.5 are exact); on random operands of
spectral radius 0.9, each entry within 1e-5 of the largest: each side
sums 128 float32 products per entry in its own order, through up to 64
dependent products, and each side lies within 2e-6 of the float64 power.

The member axis (a leading (g, ...) stack in one launch) is held against
``jax.vmap`` of the reference kernel over the same stack.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chase as jchase
from repro.kernels import compute_probe as jprobe
from repro.kernels import ref as jref
from repro.kernels import stream as jstream
from repro_torch.kernels import chase, compute_probe, counts, ops, ref, stream

I = dict(interpret=True)


def _arr(shape, seed=0):
    return np.random.default_rng(seed).uniform(
        0.5, 1.5, size=shape).astype(np.float32)


@pytest.mark.parametrize("rows,block", [(128, 128), (512, 128), (1024, 512)])
def test_read_hbm(rows, block):
    x = _arr((rows, 128))
    want = jstream.read_hbm(jnp.asarray(x), block_rows=block, **I)
    got = stream.read_hbm(torch.from_numpy(x), block_rows=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6)


@pytest.mark.parametrize("rows,block", [(256, 128), (512, 512)])
def test_write_hbm(rows, block):
    want = jstream.write_hbm(rows, value=2.5, block_rows=block, **I)
    got = stream.write_hbm(rows, value=2.5, block_rows=block, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_write_hbm_into_callers_buffer():
    out = torch.zeros((256, 128))
    got = stream.write_hbm(256, value=3.0, block_rows=128, out=out)
    assert got is out and bool((out == 3.0).all())
    with pytest.raises(ValueError):
        stream.write_hbm(128, out=out)


@pytest.mark.parametrize("rows,block", [(256, 128), (512, 512)])
def test_write_hbm_seeded(rows, block):
    seed = np.full((1, 1), 0.25, np.float32)
    want = jstream.write_hbm_seeded(jnp.asarray(seed), rows, value=2.5,
                                    block_rows=block, **I)
    got = stream.write_hbm_seeded(torch.from_numpy(seed), rows, value=2.5,
                                  block_rows=block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (value, seed) pairs whose float32 sum differs from the double sum rounded
# once: the reference rounds ``value`` to float32, then adds in float32
ROUNDED_PAIRS = [(1 / 3, 0.25), (7.7, 0.2), (1e-3, 1e-8)]


@pytest.mark.parametrize("value,seed_value", ROUNDED_PAIRS)
def test_seeded_write_rounds_as_the_reference(value, seed_value):
    """``write_hbm_seeded`` and seeded ``mixed_hbm`` bit for bit the
    reference's ``full_like(value) + seed``, at values whose sum a double
    add rounded once would store otherwise."""
    seed = np.full((1, 1), seed_value, np.float32)
    want = jstream.write_hbm_seeded(jnp.asarray(seed), 8, value=value,
                                    block_rows=8, **I)
    got = stream.write_hbm_seeded(torch.from_numpy(seed), 8, value=value,
                                  block_rows=8)
    assert _bits(got.numpy()).tolist() == _bits(want).tolist()
    x = _arr((64, 128))
    _, wout = jstream.mixed_hbm(jnp.asarray(x), read_fraction=0.5,
                                value=value, block_rows=8,
                                seed=jnp.asarray(seed), **I)
    _, gout = stream.mixed_hbm(torch.from_numpy(x), read_fraction=0.5,
                               value=value, block_rows=8,
                               seed=torch.from_numpy(seed))
    assert _bits(gout.numpy()).tolist() == _bits(wout).tolist()
    _, rout = ref.mixed_ref(torch.from_numpy(x), 0.5, value=value,
                            block_rows=8, seed=seed_value)
    assert _bits(rout.numpy()).tolist() == _bits(wout).tolist()


@pytest.mark.parametrize("rows", [1, 3, 513])
@pytest.mark.parametrize("seeded", [False, True])
def test_write_hbm_ragged_rows(rows, seeded):
    """Any whole number of rows, down to 1 (a short last chunk on the
    card), with a ``block_rows`` that divides them: bit for bit the
    reference."""
    seed = np.full((1, 1), 0.25, np.float32)
    if seeded:
        want = jstream.write_hbm_seeded(jnp.asarray(seed), rows, value=1 / 3,
                                        block_rows=rows, **I)
        got = stream.write_hbm_seeded(torch.from_numpy(seed), rows,
                                      value=1 / 3, block_rows=rows)
    else:
        want = jstream.write_hbm(rows, value=1 / 3, block_rows=rows, **I)
        got = stream.write_hbm(rows, value=1 / 3, block_rows=rows,
                               device="cpu")
    assert got.shape == (rows, 128) and got.dtype == torch.float32
    assert _bits(got.numpy()).tolist() == _bits(want).tolist()


@pytest.mark.parametrize("rows", [128, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmw_hbm(rows, dtype):
    x = _arr((rows, 128))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jstream.rmw_hbm(jx, block_rows=128, **I)
    got = stream.rmw_hbm(tx, block_rows=128)
    assert got.dtype == tx.dtype and got.data_ptr() != tx.data_ptr()
    want32 = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), want32)
    else:
        np.testing.assert_allclose(got.float().numpy(), want32, rtol=1e-2)


@pytest.mark.parametrize("shape", [(1, 128), (3, 128), (513, 128),
                                   (3, 513, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmw_hbm_ragged_rows_and_stacks(shape, dtype):
    """Any whole number of rows, down to 1, and a member stack: exact in
    both dtypes (bf16: each side rounds the float32 sum once)."""
    x = _arr(shape, seed=shape[-2])
    rows = shape[-2]
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    fn = lambda a: jstream.rmw_hbm(a, block_rows=rows, **I)  # noqa: E731
    want = jax.vmap(fn)(jx) if len(shape) == 3 else fn(jx)
    got = stream.rmw_hbm(tx, block_rows=rows)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    assert got.data_ptr() != tx.data_ptr()
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("chunk_vec", [1, 384, 512])
@pytest.mark.parametrize("n_vec", [1, 2, 32, 96, 383, 384, 385, 513 * 32,
                                   3 * 513 * 32, 1 << 20])
def test_rmw_chunks_cover_every_unit_once(n_vec, chunk_vec):
    """The kernel's chunk rule: one CTA a chunk, chunks back to back from
    unit 0, each non-empty, the last one ending at the buffer's end (short
    where the chunk does not divide it)."""
    _chunks_cover_every_unit_once(n_vec, chunk_vec)


# chunks of 4-16 KiB an input, the sizes the copy and the triad are built
# at and tried at (tools/stream_ab.py --copy-build / --triad-build)
@pytest.mark.parametrize("chunk_kib", [4, 5, 6, 8, 9, 10, 12, 16])
@pytest.mark.parametrize("n_vec", [
    32, 3 * 32, 513 * 32,          # 1, 3, 513 rows of float32 or int32
    513 * 16,                      # 513 rows of bf16
    3 * 513 * 32,                  # a 3-member stack
    1 << 26])                      # 1 GiB, the main path's buffer
def test_copy_and_triad_chunks_cover_every_unit_once(n_vec, chunk_kib):
    """Copy and triad take rmw's chunk rule (each of the triad's inputs
    cut alike): at their chunk sizes and the main path's shapes every
    unit is in exactly one CTA's chunk, a short tail included."""
    _chunks_cover_every_unit_once(n_vec, chunk_kib * 1024 // 16)


# the write's chunk sizes, built and tried (tools/stream_ab.py --write-build)
@pytest.mark.parametrize("chunk_kib", [4, 8, 10, 16, 32, 64])
@pytest.mark.parametrize("n_vec", [
    32, 3 * 32, 513 * 32,          # 1, 3, 513 rows
    2097152 * 32,                  # 1 GiB: letters w and y
    698880 * 32,                   # 1/3 GiB: letter b's write half
    524288 * 32])                  # 256 MiB: the spmd and host rows
def test_write_chunks_cover_every_unit_once(n_vec, chunk_kib):
    """The writes take rmw's chunk rule: at their chunk sizes and the main
    path's shapes every unit is in exactly one CTA's chunk, so no byte
    past the buffer's end is stored."""
    _chunks_cover_every_unit_once(n_vec, chunk_kib * 1024 // 16)


def _chunks_cover_every_unit_once(n_vec, chunk_vec):
    grid = stream.chunk_grid(n_vec, chunk_vec)
    ranges = [stream.chunk_range(b, n_vec, chunk_vec) for b in range(grid)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n_vec
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(0 < e - b <= chunk_vec for b, e in ranges)
    assert all(e - b == chunk_vec for b, e in ranges[:-1])
    assert ranges[-1][1] - ranges[-1][0] == n_vec - (grid - 1) * chunk_vec


def test_rmw_grid_refuses_an_empty_buffer():
    with pytest.raises(ValueError):
        stream.chunk_grid(0, 512)
    with pytest.raises(ValueError):
        stream.chunk_grid(512, 0)


@pytest.mark.parametrize("rows", [128, 1024])
def test_copy_hbm(rows):
    x = _arr((rows, 128))
    want = jstream.copy_hbm(jnp.asarray(x), block_rows=128, **I)
    got = stream.copy_hbm(torch.from_numpy(x), block_rows=128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.data_ptr() != torch.from_numpy(x).data_ptr()


def _bits(a) -> np.ndarray:
    """The bytes of an array as unsigned integers of its width."""
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("shape", [(1, 128), (3, 128), (513, 128),
                                   (3, 513, 128)])
@pytest.mark.parametrize("dtype", ["int32", "bfloat16", "float32"])
def test_copy_hbm_ragged_rows_stacks_and_dtypes(shape, dtype):
    """Any whole number of rows, down to 1, with one-row blocks, and a
    member stack: bit for bit the reference's copy, into a new buffer."""
    x = _arr(shape, seed=shape[-2])
    if dtype == "int32":
        x = (x * 1e6).astype(np.int32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    fn = lambda a: jstream.copy_hbm(a, block_rows=1, **I)  # noqa: E731
    want = jax.vmap(fn)(jx) if len(shape) == 3 else fn(jx)
    got = stream.copy_hbm(tx, block_rows=1)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    assert got.data_ptr() != tx.data_ptr()
    wide = torch.int16 if dtype == "bfloat16" else torch.int32
    np.testing.assert_array_equal(got.view(wide).numpy().view(
        _bits(want).dtype), _bits(want))


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("rf", [1.0, 2 / 3, 0.5, 1 / 3, 0.0])
def test_mixed_hbm(rf, seeded):
    rows, block = 1024, 128
    x = _arr((rows, 128))
    seed = np.full((1, 1), 0.5, np.float32)
    ws, wout = jstream.mixed_hbm(
        jnp.asarray(x), read_fraction=rf, block_rows=block,
        seed=jnp.asarray(seed) if seeded else None, **I)
    gs, gout = stream.mixed_hbm(
        torch.from_numpy(x), read_fraction=rf, block_rows=block,
        seed=torch.from_numpy(seed) if seeded else None)
    np.testing.assert_allclose(float(gs), float(ws), rtol=2e-6)
    assert tuple(gout.shape) == tuple(wout.shape)
    np.testing.assert_array_equal(gout.numpy(), np.asarray(wout))


@pytest.mark.parametrize("rows,block", [(8, 512), (24, 512), (64, 16),
                                        (1024, 512), (2048, 512)])
@pytest.mark.parametrize("rf", [0.05, 1 / 3, 0.5, 0.95])
def test_mixed_block_rule(rows, block, rf):
    """The block rule is part of the contract: the shapes the reference
    returns are the shapes the port's split gives."""
    block = min(block, rows)
    x = np.ones((rows, 128), np.float32)
    ws, wout = jstream.mixed_hbm(jnp.asarray(x), read_fraction=rf,
                                 block_rows=block, **I)
    b, n_r, n_w = ref.mixed_split(rows, rf, block)
    assert wout.shape == (n_w * b, 128)
    assert float(ws) == n_r * b * 128
    if rows >= 2:
        assert n_r >= 1 and n_w >= 1


@pytest.mark.parametrize("repeats", [1, 4])
def test_read_write_vmem(repeats):
    x = _arr((256, 128))
    want = jstream.read_vmem(jnp.asarray(x), repeats=repeats, **I)
    got = stream.read_vmem(torch.from_numpy(x), repeats=repeats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6)
    wantw = jstream.write_vmem(256, repeats=repeats, **I)
    gotw = stream.write_vmem(256, repeats=repeats, device="cpu")
    np.testing.assert_array_equal(gotw.numpy(), np.asarray(wantw))


def _slices(rows, lay):
    """The rows each CTA holds, as the kernels index them: CTA b owns
    [b * slice_rows, min(rows, (b + 1) * slice_rows))."""
    return [(b * lay.slice_rows, min(rows, (b + 1) * lay.slice_rows))
            for b in range(lay.ctas)]


@pytest.mark.parametrize("sms", [132, 114, 8, 1])
@pytest.mark.parametrize("rows", [8, 256, 453, 2048 + 8, 132 * 453 + 40])
def test_vmem_layout_covers_the_rows_once(rows, sms):
    """The on-chip pair's launch layout: every row in exactly one slice,
    no slice above one SM's tile, one CTA an SM for a buffer that fits the
    SMs' shared memory, and a ragged last slice that is not empty."""
    lay = stream.vmem_layout(rows, sms)
    sl = _slices(rows, lay)
    covered = np.zeros(rows, dtype=int)
    for lo, hi in sl:
        assert 0 <= lo < hi <= rows
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert 1 <= lay.slice_rows <= stream.SMEM_TILE_ROWS
    assert all(hi - lo <= lay.slice_rows for lo, hi in sl)
    if rows <= sms * stream.SMEM_TILE_ROWS:
        assert lay.ctas <= sms
    else:
        assert lay.slice_rows == stream.SMEM_TILE_ROWS
    # a slice of at least the least rows, when the buffer has them
    assert lay.slice_rows >= min(rows, stream.VMEM_MIN_SLICE_ROWS)


def test_vmem_layout_at_the_card_shapes():
    """The layouts the main path and chip_smoke.py's on-chip cases launch
    on an H100's 132 SMs."""
    got = {rows: tuple(stream.vmem_layout(rows, 132))
           for rows in (8, 256, 453, 2048 + 8)}
    assert got == {8: (4, 2), 256: (128, 2), 453: (114, 4), 2056: (129, 16)}
    # the last slice of 453 rows is one row; of 2056 rows, 8
    assert _slices(453, stream.vmem_layout(453, 132))[-1] == (452, 453)
    assert _slices(2056, stream.vmem_layout(2056, 132))[-1] == (2048, 2056)
    with pytest.raises(ValueError):
        stream.vmem_layout(0, 132)
    with pytest.raises(ValueError):
        stream.vmem_layout(8, 0)


@pytest.mark.parametrize("n_lines", [2, 16, 64, 257])
@pytest.mark.parametrize("seed", [0, 3])
def test_chase_vmem(n_lines, seed):
    buf = chase.chain_buffer(n_lines, seed)
    for steps in (1, n_lines // 2 or 1, n_lines):
        want = jchase.chase_vmem(jnp.asarray(buf), n_steps=steps, **I)
        got = chase.chase_vmem(torch.from_numpy(buf), n_steps=steps)
        assert int(got) == int(want) == ref.chase_ref(buf, steps)
    assert int(chase.chase_vmem(torch.from_numpy(buf),
                                n_steps=n_lines)) == 0


@pytest.mark.parametrize("n_lines", [8, 64])
def test_chase_hbm(n_lines):
    buf = chase.chain_buffer(n_lines, 1)
    want = jchase.chase_hbm(jnp.asarray(buf), n_steps=n_lines, **I)
    got = chase.chase_hbm(torch.from_numpy(buf), n_steps=n_lines)
    assert int(got) == int(want) == 0


def test_chase_vmem_refuses_a_chain_larger_than_one_sm():
    buf = torch.zeros((512, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        chase.chase_vmem(buf, n_steps=1)


@pytest.mark.parametrize("n_lines", [1, 2, 7, 64, 100, 513])
@pytest.mark.parametrize("seed", [0, 2, 11])
def test_make_chain_bit_identical(n_lines, seed):
    a, b = jchase.make_chain(n_lines, seed), chase.make_chain(n_lines, seed)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(jchase.chain_buffer(n_lines, seed),
                                  ops.chain_buffer(n_lines, seed))


@pytest.mark.parametrize("n_lines", [1, 2, 3, 17, 4096, 1 << 16])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_one_call_draws_equal_the_reference_scalar_loop(n_lines, seed):
    """The port draws every Sattolo j in one generator call; the
    reference draws them one by one.  The chains are the same, up to the
    sizes whose chains the port builds once a 256 MiB chase is placed."""
    a, b = jchase.make_chain(n_lines, seed), chase.make_chain(n_lines, seed)
    assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    assert sorted(b.tolist()) == list(range(n_lines))


@pytest.mark.parametrize("n_lines", [1, 2, 7, 64, 100])
@pytest.mark.parametrize("stride", [1, 4, 8, 50])
def test_make_strided_chain_bit_identical(n_lines, stride):
    np.testing.assert_array_equal(
        jchase.make_strided_chain(n_lines, stride),
        chase.make_strided_chain(n_lines, stride))
    np.testing.assert_array_equal(
        jchase.strided_chain_buffer(n_lines, stride),
        ops.strided_chain_buffer(n_lines, stride))


@pytest.mark.parametrize("call", [
    lambda: stream.read_hbm(torch.zeros((128, 64))),
    lambda: stream.read_hbm(torch.zeros((128, 128), dtype=torch.float64)),
    lambda: stream.read_hbm(torch.zeros((256, 128))[::2]),
    lambda: stream.read_hbm(torch.zeros((100, 128)), block_rows=64),
    lambda: stream.rmw_hbm(torch.zeros((128, 128), dtype=torch.int32)),
    lambda: stream.read_vmem(torch.zeros((128, 128)), repeats=0),
    lambda: chase.chase_hbm(torch.zeros((8, 128)), n_steps=1),
    lambda: stream.write_hbm_seeded(torch.zeros((2, 1)), 128,
                                    block_rows=128),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(call):
    with pytest.raises((TypeError, ValueError)):
        call()


def test_cpu_tensors_take_the_plain_versions_and_are_counted():
    counts.reset()
    x = torch.from_numpy(_arr((128, 128)))
    stream.read_hbm(x, block_rows=128)
    stream.copy_hbm(x, block_rows=128)
    ops.chase_hbm(torch.from_numpy(chase.chain_buffer(8, 0)), n_steps=8)
    launches, plain = counts.snapshot()
    assert not any(launches.values())
    assert plain["read_hbm"] == plain["copy_hbm"] == plain["chase_hbm"] == 1
    assert sum(plain.values()) == 3


# ---------------------------------------------------------------------------
# compute probe
# ---------------------------------------------------------------------------


def test_mxu_probe():
    """The reference's own case, at its tolerance."""
    a = np.eye(128, dtype=np.float32) * 0.5
    want = jprobe.mxu_probe(jnp.asarray(a), iters=3, **I)
    got = compute_probe.mxu_probe(torch.from_numpy(a), iters=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jref.mxu_probe_ref(a, 3)),
                               rtol=1e-6)


def _radius_09(seed):
    a = np.random.default_rng(seed).standard_normal((128, 128))
    return (a / np.abs(np.linalg.eigvals(a)).max() * 0.9).astype(np.float32)


@pytest.mark.parametrize("iters", [0, 1, 8, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_mxu_probe_random(seed, iters):
    a = _radius_09(seed)
    want = np.asarray(jprobe.mxu_probe(jnp.asarray(a), iters=iters, **I))
    oracle = np.asarray(jref.mxu_probe_ref(jnp.asarray(a), iters))
    got = compute_probe.mxu_probe(torch.from_numpy(a), iters=iters).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(got - oracle).max() <= 1e-5 * scale
    assert got.shape == (128, 128) and got.dtype == np.float32


@pytest.mark.parametrize("call", [
    lambda: compute_probe.mxu_probe(torch.zeros((64, 128))),
    lambda: compute_probe.mxu_probe(torch.zeros((128, 128),
                                                dtype=torch.float64)),
    lambda: compute_probe.mxu_probe(torch.zeros((128, 256))[:, ::2]),
    lambda: compute_probe.mxu_probe(torch.zeros((128, 128)), iters=-1),
])
def test_mxu_probe_refuses_what_the_kernel_does_not_take(call):
    with pytest.raises(ValueError):
        call()


# ---------------------------------------------------------------------------
# member axis: one launch over a (g, ...) stack = jax.vmap of the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("g", [1, 3, 4])
def test_read_hbm_members(g):
    x = _arr((g, 512, 128), seed=g)
    want = jax.vmap(lambda a: jstream.read_hbm(a, block_rows=128, **I))(
        jnp.asarray(x))
    got = stream.read_hbm(torch.from_numpy(x), block_rows=128)
    assert tuple(got.shape) == (g,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6)


@pytest.mark.parametrize("g", [1, 3, 4])
def test_read_vmem_members(g):
    x = _arr((g, 256, 128), seed=g)
    want = jax.vmap(lambda a: jstream.read_vmem(a, repeats=3, **I))(
        jnp.asarray(x))
    got = stream.read_vmem(torch.from_numpy(x), repeats=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6)


@pytest.mark.parametrize("g", [1, 3, 4])
def test_copy_and_rmw_members(g):
    x = _arr((g, 256, 128), seed=g)
    jx = jnp.asarray(x)
    want_c = jax.vmap(lambda a: jstream.copy_hbm(a, block_rows=128, **I))(jx)
    want_r = jax.vmap(lambda a: jstream.rmw_hbm(a, block_rows=128, **I))(jx)
    got_c = stream.copy_hbm(torch.from_numpy(x), block_rows=128)
    got_r = stream.rmw_hbm(torch.from_numpy(x), block_rows=128)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))


@pytest.mark.parametrize("g", [1, 3, 4])
@pytest.mark.parametrize("rf", [2 / 3, 0.5, 0.05])
def test_mixed_hbm_members(g, rf):
    """The block rule per member: the realised r:w split of each member
    is the reference's."""
    x = _arr((g, 1024, 128), seed=g)
    ws, wout = jax.vmap(lambda a: jstream.mixed_hbm(
        a, read_fraction=rf, block_rows=512, **I))(jnp.asarray(x))
    gs, gout = stream.mixed_hbm(torch.from_numpy(x), read_fraction=rf,
                                block_rows=512,
                                seed=torch.zeros((1, 1)))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=2e-6)
    assert tuple(gout.shape) == tuple(wout.shape)
    np.testing.assert_array_equal(gout.numpy(), np.asarray(wout))


@pytest.mark.parametrize("g", [1, 3, 4])
@pytest.mark.parametrize("n_lines", [16, 257])
def test_chases_members(g, n_lines):
    bufs = np.stack([chase.chain_buffer(n_lines, s) for s in range(g)])
    for steps in (1, n_lines // 3, n_lines, 3 * n_lines):
        jv = jax.vmap(lambda b: jchase.chase_vmem(b, n_steps=steps, **I))(
            jnp.asarray(bufs))
        jh = jax.vmap(lambda b: jchase.chase_hbm(b, n_steps=steps, **I))(
            jnp.asarray(bufs))
        gv = chase.chase_vmem(torch.from_numpy(bufs), n_steps=steps)
        gh = chase.chase_hbm(torch.from_numpy(bufs), n_steps=steps)
        want = ref.chase_members_ref(bufs, steps)
        assert gv.tolist() == gh.tolist() == want
        assert want == np.asarray(jv).tolist() == np.asarray(jh).tolist()


def test_member_views_and_refusals():
    """A member stack may be a strided view (the mixed stream reads the
    first blocks of every member); copy and rmw want a contiguous stack."""
    x = torch.from_numpy(_arr((3, 512, 128)))
    view = x[:, :256]
    np.testing.assert_allclose(stream.read_hbm(view, block_rows=128).numpy(),
                               view.sum(dim=(1, 2)).numpy(), rtol=2e-6)
    with pytest.raises(ValueError, match="contiguous"):
        stream.copy_hbm(view, block_rows=128)
    with pytest.raises(ValueError, match="contiguous"):
        stream.read_hbm(x.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        stream.write_hbm(128, out=torch.zeros((2, 64, 128)))
    with pytest.raises(ValueError, match="shared memory"):
        chase.chase_vmem(torch.zeros((2, 512, 128), dtype=torch.int32),
                         n_steps=1)


@pytest.mark.parametrize("rows,block", [(512, 128), (1024, 512)])
@pytest.mark.parametrize("scalar", [3.0, -0.7])
def test_triad_hbm(rows, block, scalar):
    b, c = _arr((rows, 128), 1), _arr((rows, 128), 2)
    want = jstream.triad_hbm(jnp.asarray(b), jnp.asarray(c), scalar=scalar,
                             block_rows=block, **I)
    counts.reset()
    got = ops.stream_triad(torch.from_numpy(b), torch.from_numpy(c),
                           scalar=scalar, block_rows=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    # the plain version rounds the product and the sum apart, as the
    # kernel does
    np.testing.assert_array_equal(
        got.numpy(), (np.float32(scalar) * c + b).astype(np.float32))
    assert counts.PLAIN["triad_hbm"] == 1 and not any(counts.LAUNCHES.values())


@pytest.mark.parametrize("rows", [1, 3, 513])
def test_triad_hbm_ragged_rows(rows):
    """Any whole number of rows, down to 1, with one-row blocks: the
    reference's triad within one float32 rounding (XLA on the CPU may fuse
    its product into the sum, as test_triad_hbm allows), and exactly the
    product and the sum rounded apart."""
    b, c = _arr((rows, 128), rows), _arr((rows, 128), rows + 1)
    want = jstream.triad_hbm(jnp.asarray(b), jnp.asarray(c), scalar=3.0,
                             block_rows=1, **I)
    got = stream.triad_hbm(torch.from_numpy(b), torch.from_numpy(c),
                           scalar=3.0, block_rows=1)
    assert got.shape == (rows, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    np.testing.assert_array_equal(
        got.numpy(), (np.float32(3.0) * c + b).astype(np.float32))


@pytest.mark.parametrize("b,c", [
    ((512, 128), (256, 128)),
    ((512, 64), (512, 64)),
    ((2, 512, 128), (2, 512, 128)),
])
def test_triad_refuses_what_the_kernel_does_not_take(b, c):
    with pytest.raises(ValueError):
        stream.triad_hbm(torch.zeros(b), torch.zeros(c), block_rows=128)


def test_triad_refuses_operands_in_two_memories():
    with pytest.raises(ValueError, match="same memory"):
        stream.triad_hbm(torch.zeros((512, 128)),
                         torch.zeros((512, 128), device="meta"))


def test_triad_refuses_other_dtypes_and_ragged_blocks():
    with pytest.raises(TypeError):
        stream.triad_hbm(torch.zeros((512, 128), dtype=torch.bfloat16),
                         torch.zeros((512, 128), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        stream.triad_hbm(torch.zeros((384, 128)), torch.zeros((384, 128)),
                         block_rows=256)
