"""Port vs reference: device trees, pools, converters, counters (CPU)."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import devicetree as jdt
from repro.core import pools as jpools
from repro.core import workloads as jwl
from repro.core.counters import EVENTS as J_EVENTS
from repro.core.counters import MAX_COUNTERS as J_MAX
from repro_torch.core import (convert, counters, devicetree, pools,
                              workloads)

REF_TREES = {"tpu-v5e": jdt.TPU_V5E, "zcu102": jdt.ZCU102,
             "zcu102-partitioned": jdt.zcu102_partitioned()}


def _converted(name):
    p = REF_TREES[name]
    return convert.platform_from_reference_json(p.to_json(), p.cache_node)


# -- device trees ---------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(REF_TREES))
def test_platform_json_round_trips_byte_identical(name):
    text = REF_TREES[name].to_json()
    plat = _converted(name)
    assert plat.to_json() == text
    assert devicetree.Platform.from_json(plat.to_json()).to_json() == text
    assert plat.cache_node == REF_TREES[name].cache_node
    for k, node in REF_TREES[name].memories.items():
        assert dataclasses.asdict(plat.memories[k]) == \
            dataclasses.asdict(node)
        assert plat.memories[k].reg == node.reg


@pytest.mark.parametrize("own,theirs", [
    (devicetree.ZCU102, jdt.ZCU102),
    (devicetree.zcu102_partitioned(), jdt.zcu102_partitioned())])
def test_zcu102_copies_equal_the_reference(own, theirs):
    assert own.to_json() == theirs.to_json()
    assert own.cache_node == theirs.cache_node == "l2"


def test_convert_refuses_a_cache_node_that_names_no_memory():
    with pytest.raises(KeyError):
        convert.platform_from_reference_json(jdt.ZCU102.to_json(), "l3")


def test_h100_tree_is_well_formed():
    p = devicetree.H100_SXM
    assert p.cache_node in p.memories
    assert p.memories[p.cache_node].kind == "cache"
    assert p.shared_port in p.ports
    for node in p.memories.values():
        assert node.port in p.ports
        assert node.size_bytes > 0 and node.peak_bw_gbps > 0
    assert p.line_bytes == workloads.LINE_BYTES == 512
    assert p.n_engines == 8
    kinds = {n.name: (n.kind, n.memory_kind) for n in p.memories.values()}
    assert kinds == {"hbm": ("hbm", "device"), "vmem": ("vmem", None),
                     "l2": ("cache", None), "host": ("host", "pinned_host"),
                     "peer": ("peer", None)}
    assert p.memories["vmem"].size_bytes == workloads.SMEM_RESIDENT_BYTES
    assert p.memories["l2"].size_bytes == workloads.CACHE_RESIDENT_BYTES
    assert devicetree.Platform.from_json(p.to_json()).memories == p.memories


def test_no_tpu_tree_in_the_port():
    assert not hasattr(devicetree, "TPU_V5E")
    with pytest.raises(KeyError):
        devicetree.detect_platform("tpu-v5e")


@pytest.mark.parametrize("name,want", [("h100-sxm", "h100-sxm"),
                                       ("zcu102", "zcu102")])
def test_detect_platform_by_name(name, want):
    assert devicetree.detect_platform(name).name == want


def test_detect_platform_on_the_cpu_is_the_h100_model():
    assert devicetree.detect_platform(device="cpu") is devicetree.H100_SXM


# -- pools ----------------------------------------------------------------------


def _pool_pair(name="tpu-v5e"):
    jm = jpools.PoolManager(REF_TREES[name])
    tm = pools.PoolManager(_converted(name), device="cpu")
    return jm, tm


@pytest.mark.parametrize("name", sorted(REF_TREES))
def test_pool_status_text_equal(name):
    jm, tm = _pool_pair(name)
    assert tm.status() == jm.status()
    assert [p.id for p in tm.pools()] == [p.id for p in jm.pools()]


def test_pool_accounting_equal_through_alloc_and_free():
    jm, tm = _pool_pair()
    ja = jm.pool("hbm").alloc((512, 128), jnp.float32, tag="a")
    ta = tm.pool("hbm").alloc((512, 128), torch.float32, tag="a")
    jb = jm.pool("host").alloc((256, 128), jnp.int32, tag="b")
    tb = tm.pool("host").alloc((256, 128), torch.int32, tag="b")
    jv = jm.pool("vmem").alloc((64, 128), jnp.float32)
    tv = tm.pool("vmem").alloc((64, 128), torch.float32)
    assert (ta.nbytes, tb.nbytes, tv.nbytes) == \
        (ja.nbytes, jb.nbytes, jv.nbytes)
    assert tv.array is None and jv.array is None     # residency grant
    assert tuple(ta.array.shape) == ja.array.shape
    assert tm.status() == jm.status()
    for n in ("hbm", "host", "vmem"):
        assert tm.pool(n).available == jm.pool(n).available
    jm.pool("hbm").free(ja)
    tm.pool("hbm").free(ta)
    assert ta.array is None
    assert tm.status() == jm.status()
    jm.destroy_all()
    tm.destroy_all()
    assert tm.status() == jm.status()


def test_pool_double_free_and_foreign_handle_messages_equal():
    jm, tm = _pool_pair()
    ja = jm.pool("hbm").alloc((8, 128))
    ta = tm.pool("hbm").alloc((8, 128))
    jm.pool("hbm").free(ja)
    tm.pool("hbm").free(ta)
    with pytest.raises(jpools.PoolError) as je:
        jm.pool("hbm").free(ja)
    with pytest.raises(pools.PoolError) as te:
        tm.pool("hbm").free(ta)
    assert str(te.value) == str(je.value)


def test_pool_over_capacity_message_equal():
    jm, tm = _pool_pair("zcu102")
    shape = (1 << 20, 128)                  # 512 MiB > the 256 MiB dram
    with pytest.raises(jpools.PoolError) as je:
        jm.pool("dram").alloc(shape)
    with pytest.raises(pools.PoolError) as te:
        tm.pool("dram").alloc(shape)
    assert str(te.value) == str(je.value)
    assert tm.pool("dram").allocated == 0


@pytest.mark.parametrize("key", ["nope", 99])
def test_pool_lookup_errors_equal(key):
    jm, tm = _pool_pair()
    with pytest.raises(jpools.PoolError) as je:
        jm.pool(key)
    with pytest.raises(pools.PoolError) as te:
        tm.pool(key)
    assert str(te.value) == str(je.value)
    assert tm.pool(0).node.name == jm.pool(0).node.name


def test_alloc_init_values_equal_the_reference():
    jm, tm = _pool_pair()
    ja = jm.pool("hbm").alloc((16, 128), jnp.float32,
                              init=jwl.bw_buffer_init)
    ta = tm.pool("hbm").alloc((16, 128), torch.float32,
                              init=workloads.bw_buffer_init)
    np.testing.assert_array_equal(ta.array.numpy(), np.asarray(ja.array))
    np.testing.assert_array_equal(
        workloads.latency_buffer_init(33, 4).numpy(),
        np.asarray(jwl.latency_buffer_init(33, 4)))


def test_effective_memory_kind_on_the_cpu():
    """With device="cpu" there is no page-locked memory: a pinned_host
    pool holds ordinary host tensors and says so."""
    tm = pools.PoolManager(devicetree.H100_SXM, device="cpu")
    assert tm.pool("hbm").effective_memory_kind() is None
    assert tm.pool("host").effective_memory_kind() is None
    a = tm.pool("host").alloc((8, 128))
    assert a.array.device.type == "cpu" and not a.array.is_pinned()


def test_user_pool_places_dicts_and_lists():
    tm = pools.PoolManager(devicetree.H100_SXM, device="cpu")
    up = tm.upool("hbm")
    tree = {"k": torch.ones(3), "layers": [torch.zeros(2), (torch.ones(1),)]}
    out = up.place(tree)
    assert up.name == "hbm"
    assert set(out) == {"k", "layers"} and isinstance(out["layers"][1], tuple)
    assert torch.equal(out["layers"][1][0], torch.ones(1))


def test_buffer_from_numpy_keeps_values_and_dtype():
    tm = pools.PoolManager(devicetree.H100_SXM, device="cpu")
    arr = np.arange(2 * 128, dtype=np.int32).reshape(2, 128)
    t = convert.buffer_from_numpy(arr, tm.pool("hbm"))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), arr)
    f = convert.buffer_from_numpy(arr.astype(np.float32)[:, ::2],
                                  tm.pool("host"))
    assert f.is_contiguous() and f.shape == (2, 64)


# -- counters ---------------------------------------------------------------------


def test_counter_events_are_the_reference_names():
    assert counters.EVENTS == J_EVENTS and counters.MAX_COUNTERS == J_MAX
    assert counters.select_events(("WALL_NS", "HLO_BYTES")) == \
        ("WALL_NS", "HLO_BYTES")
    with pytest.raises(KeyError):
        counters.select_events(("CYCLES",))
    with pytest.raises(ValueError):
        counters.select_events(counters.EVENTS + ("WALL_NS",))


def test_counter_sample_takes_analytic_cost():
    x = torch.ones((64, 128))
    s = counters.sample(lambda t: t.sum(), x, iters=2, flops=64 * 128,
                        bytes=64 * 512, device="cpu")
    assert s["HLO_FLOPS"] == 64 * 128 and s["HLO_BYTES"] == 64 * 512
    assert s["TRANSACTIONS"] == 64 and s["WALL_NS"] > 0
    assert s["NS_PER_TX"] == pytest.approx(s["WALL_NS"] / 64)
    assert s["PEAK_MEMORY"] == 0.0
    assert list(s.events) == list(counters.EVENTS)
    assert json.loads(json.dumps(s.events)) == s.events
    assert "WALL_NS=" in s.as_row()
