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
bits), the reference's own.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chase as jchase
from repro.kernels import stream as jstream
from repro_torch.kernels import chase, counts, ops, ref, stream

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


@pytest.mark.parametrize("rows", [128, 1024])
def test_copy_hbm(rows):
    x = _arr((rows, 128))
    want = jstream.copy_hbm(jnp.asarray(x), block_rows=128, **I)
    got = stream.copy_hbm(torch.from_numpy(x), block_rows=128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.data_ptr() != torch.from_numpy(x).data_ptr()


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
