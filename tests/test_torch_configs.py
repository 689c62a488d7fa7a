"""Port vs reference for the configurations package, on the CPU.

``repro_torch.configs`` is a copy of ``repro.configs`` with its imports
re-pointed: a configuration is data, so every registered configuration,
its ``reduced()`` twin, what they compute, the shapes and the registry must
be equal across the two packages.
"""
import dataclasses

import pytest

import repro.configs as jcfg
import repro_torch.configs as tcfg

NAMES = sorted(jcfg.list_configs())


def test_registry_and_shapes_are_equal():
    assert tcfg.ALL_ARCHS == jcfg.ALL_ARCHS
    assert tcfg.list_configs() == NAMES
    assert sorted(jcfg.ALL_ARCHS) == NAMES
    assert tcfg.SHAPE_ORDER == jcfg.SHAPE_ORDER
    assert {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()}
    assert {k: v.tokens for k, v in tcfg.SHAPES.items()} == \
        {k: v.tokens for k, v in jcfg.SHAPES.items()}
    for cls in ("TrainConfig", "ServeConfig", "MeshConfig", "MoEConfig",
                "SSMConfig"):
        assert dataclasses.asdict(getattr(tcfg, cls)()) == \
            dataclasses.asdict(getattr(jcfg, cls)())
    with pytest.raises(KeyError):
        tcfg.get_config("no-such-arch")


def _pair(name, reduced):
    a, b = jcfg.get_config(name), tcfg.get_config(name)
    return (a.reduced(), b.reduced()) if reduced else (a, b)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_config_is_equal(name, reduced):
    a, b = _pair(name, reduced)
    assert type(b).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(b) == dataclasses.asdict(a)
    assert b.param_counts() == a.param_counts()
    assert (b.n_params(), b.n_active_params()) == \
        (a.n_params(), a.n_active_params())
    assert [b.layer_kind(i) for i in range(b.n_layers)] == \
        [a.layer_kind(i) for i in range(a.n_layers)]
    assert [b.layer_is_moe(i) for i in range(b.n_layers)] == \
        [a.layer_is_moe(i) for i in range(a.n_layers)]
    assert [b.layer_is_global_attn(i) for i in range(b.n_layers)] == \
        [a.layer_is_global_attn(i) for i in range(a.n_layers)]
    assert (b.shapes(), b.padded_vocab, b.sub_quadratic,
            b.is_attention_free) == (a.shapes(), a.padded_vocab,
                                     a.sub_quadratic, a.is_attention_free)


@pytest.mark.parametrize("mesh", [(16, 16, 1), (8, 1, 1), (4, 2, 2),
                                  (1, 1, 1)])
@pytest.mark.parametrize("name", NAMES)
def test_default_microbatches_are_equal(name, mesh):
    data, model, pods = mesh
    for shape in jcfg.SHAPE_ORDER:
        want = jcfg.default_microbatches(
            jcfg.get_config(name), jcfg.SHAPES[shape],
            jcfg.MeshConfig(data, model, pods))
        got = tcfg.default_microbatches(
            tcfg.get_config(name), tcfg.SHAPES[shape],
            tcfg.MeshConfig(data, model, pods))
        assert got == want, shape


def test_the_attention_widths_the_chip_check_takes():
    """chip_smoke.py sizes flash attention from these configurations."""
    q, g = tcfg.get_config("qwen2-1.5b"), tcfg.get_config("gemma3-1b")
    assert (q.n_heads, q.n_kv_heads, q.head_dim) == (12, 2, 128)
    assert (g.n_heads, g.n_kv_heads, g.head_dim, g.sliding_window) == \
        (4, 1, 256, 512)
    assert tcfg.SHAPES["prefill_32k"].seq_len == 32768
