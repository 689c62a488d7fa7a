"""Port vs reference for the token data pipeline, on the CPU.

The sources are pure numpy in both packages, so the same ``(seed, step)``
must give the same tokens bit for bit; the loader's labels, masks and
frontend stubs must equal the reference's too.  The port's loader puts a
batch on its device (here ``device="cpu"``; beside a card through pinned
memory with ``non_blocking`` copies).
"""
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.base import get_config as jget_config
from repro.data.pipeline import DataLoader as JDataLoader
from repro.data.pipeline import MemmapSource as JMemmapSource
from repro.data.pipeline import SyntheticSource as JSyntheticSource
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import DataLoader, MemmapSource, SyntheticSource


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 1), (3, 17), (7, 123456)])
def test_synthetic_tokens_are_bit_equal_to_the_reference(seed, step):
    got = SyntheticSource(151936, seed).batch(step, 4, 64)
    want = JSyntheticSource(151936, seed).batch(step, 4, 64)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_synthetic_restart_safe():
    s = SyntheticSource(1000, seed=3)
    a = s.batch(17, 4, 32)
    np.testing.assert_array_equal(a, SyntheticSource(1000, 3).batch(17, 4, 32))
    assert not np.array_equal(a, s.batch(18, 4, 32))
    assert a.shape == (4, 33) and a.min() >= 0 and a.max() < 1000


def test_memmap_source_is_bit_equal_to_the_reference(tmp_path):
    toks = (np.arange(10_000, dtype=np.uint16) * 7) % 600
    p = str(tmp_path / "tokens.bin")
    toks.tofile(p)
    for step in (0, 3, 200):
        got = MemmapSource(p, vocab_size=500).batch(step, 2, 16)
        want = JMemmapSource(p, vocab_size=500).batch(step, 2, 16)
        np.testing.assert_array_equal(got, want)
        assert (got < 500).all()


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "internvl2-26b",
                                  "musicgen-large"])
@pytest.mark.parametrize("step", [0, 5])
def test_loader_batches_equal_the_reference(arch, step):
    """Tokens, labels (the next tokens; -1 over a VLM's image prefix) and
    the frontend stubs, host and device batch alike."""
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    loader = DataLoader(cfg, ShapeSpec("t", 16, 2, "train"), seed=2,
                        device="cpu")
    jloader = JDataLoader(jcfg, JShapeSpec("t", 16, 2, "train"), seed=2)
    hb, jb = loader.host_batch(step), jloader.host_batch(step)
    np.testing.assert_array_equal(hb.tokens, jb.tokens)
    np.testing.assert_array_equal(hb.labels, jb.labels)
    if cfg.frontend != "vlm":
        np.testing.assert_array_equal(hb.tokens[:, 1:], hb.labels[:, :-1])
    assert (hb.frontend is None) == (jb.frontend is None)
    db = loader.device_batch(step)
    assert isinstance(db.tokens, torch.Tensor) and db.tokens.device.type \
        == "cpu"
    np.testing.assert_array_equal(db.tokens.numpy(), np.asarray(jb.tokens))
    np.testing.assert_array_equal(db.labels.numpy(), np.asarray(jb.labels))
    if jb.frontend is not None:
        for k, v in jb.frontend.items():
            np.testing.assert_array_equal(hb.frontend[k], v)
            np.testing.assert_array_equal(db.frontend[k].numpy(), v)
    if cfg.frontend == "vlm":
        assert (hb.labels[:, :cfg.n_prefix_embeds] == -1).all()


def test_prefetch_iterator_yields_the_steps_in_order():
    cfg = get_config("qwen2-1.5b").reduced()
    loader = DataLoader(cfg, ShapeSpec("t", 8, 2, "train"), seed=1,
                        prefetch=2, device="cpu")
    it = iter(loader)
    batches = [next(it) for _ in range(3)]
    it.close()
    for step, b in enumerate(batches):
        np.testing.assert_array_equal(b.tokens.numpy(),
                                      loader.host_batch(step).tokens)


def test_loader_defaults_to_the_card():
    import inspect
    assert inspect.signature(DataLoader).parameters["device"].default \
        == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DataLoader(get_config("qwen2-1.5b").reduced(),
                       ShapeSpec("t", 8, 2, "train"))
