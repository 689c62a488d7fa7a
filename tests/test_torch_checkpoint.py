"""Port vs reference for checkpoints and the resilient train loop, on the
CPU.

The port's ``CheckpointManager`` writes the reference's layout (a
manifest and one ``.npy`` a leaf, keyed by the same leaf paths), so a
float32 train state converted from the reference gives the same manifest,
and a checkpoint the reference wrote restores in the port bit for bit.  A
bfloat16 leaf is stored by its 16-bit patterns with ``"dtype":
"bfloat16"`` (numpy has no bfloat16 without ``ml_dtypes``).
``ResilientLoop`` is the reference's loop over the port's checkpoints and
the shared fault seam (``REPRO_FAULT_SPEC``).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.base import get_config as jget_config
from repro.train import step as jstep
from repro_torch import tree
from repro_torch.checkpoint.manager import MANIFEST, CheckpointManager
from repro_torch.models import convert
from repro_torch.optim.adamw import OptState
from repro_torch.runtime.fault_tolerance import (InjectedFault, LoopResult,
                                                 ResilientLoop,
                                                 StragglerMonitor, drill_at)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 8), generator=g),
                       "b": torch.zeros(8),
                       "h": torch.randn((3, 5), generator=g).to(
                           torch.bfloat16)},
            "opt": OptState(m={"w": torch.ones(8, 8)},
                            v={"w": torch.full((8, 8), 2.0)},
                            step=torch.tensor(7, dtype=torch.int32))}


def test_save_restore_roundtrip_with_bf16_leaves(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    s = _state()
    mgr.save(s, 10)
    assert mgr.steps() == [10]
    r = mgr.restore(tree.tree_map(lambda t: t.to("meta"), s))
    assert isinstance(r["opt"], OptState)
    for (path, a), (_, b) in zip(tree.flatten_with_path(s),
                                 tree.flatten_with_path(r)):
        assert a.dtype == b.dtype and b.device.type == "cpu", path
        assert torch.equal(a, b), path
    with open(os.path.join(str(tmp_path), "step_00000010", MANIFEST)) as f:
        man = json.load(f)
    assert man["leaves"]["params/h"]["dtype"] == "bfloat16"
    arr = np.load(os.path.join(str(tmp_path), "step_00000010",
                               man["leaves"]["params/h"]["file"]))
    assert arr.dtype == np.uint16       # the 16-bit patterns


def test_restore_rejects_shape_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(), 1)
    bad = _state()
    bad["params"]["w"] = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="params/w"):
        mgr.restore(bad)
    missing = _state()
    missing["params"]["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="params/extra"):
        mgr.restore(missing)


def test_atomicity_tmp_never_visible(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(_state(), 1)
    stale = os.path.join(str(tmp_path), "step_00000002.tmp")
    os.makedirs(stale)
    with open(os.path.join(stale, "x.npy"), "w") as f:
        f.write("junk")
    assert mgr.steps() == [1] and mgr.latest_step() == 1
    os.makedirs(os.path.join(str(tmp_path), "step_00000003"))
    assert mgr.steps() == [1]
    # a save over a stale .tmp of its own step replaces it
    os.makedirs(os.path.join(str(tmp_path), "step_00000004.tmp"))
    mgr.save(_state(), 4)
    assert mgr.steps() == [1, 4]
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           "step_00000004.tmp"))


def test_gc_keeps_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(_state(s), s)
    assert mgr.steps() == [3, 4]


def test_async_save_snapshots_before_returning(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    s = _state()
    saved = s["params"]["w"].clone()
    mgr.save_async(s, 5)
    s["params"]["w"].add_(1.0)          # an in-place step after the call
    mgr.wait()
    assert mgr.steps() == [5]
    r = mgr.restore(_state())
    assert torch.equal(r["params"]["w"], saved)


def _reference_f32_state():
    jcfg = jget_config("qwen2-1.5b").reduced()
    jt = JTrainConfig(grad_compression="int8_ef")
    return jstep.init_state(jcfg, jt, jax.random.PRNGKey(3))


def test_manifest_matches_the_reference_for_a_converted_state(tmp_path):
    """The same float32 train state (params, OptState, error state) saved
    by both packages: the same leaf paths, files, shapes and dtype names,
    and the same bytes in every file."""
    jst = _reference_f32_state()
    JCheckpointManager(str(tmp_path / "ref")).save(jst, 3)
    tst = convert.train_state_from_numpy(jax.tree.map(np.asarray, jst),
                                         "cpu")
    CheckpointManager(str(tmp_path / "port")).save(tst, 3)
    mans = []
    for d in ("ref", "port"):
        with open(tmp_path / d / "step_00000003" / MANIFEST) as f:
            mans.append(json.load(f))
    assert mans[0] == mans[1]
    assert "opt/.m/embed" in mans[1]["leaves"]
    assert mans[1]["leaves"]["opt/.step"]["dtype"] == "int32"
    for meta in mans[0]["leaves"].values():
        a = np.load(tmp_path / "ref" / "step_00000003" / meta["file"])
        b = np.load(tmp_path / "port" / "step_00000003" / meta["file"])
        np.testing.assert_array_equal(a, b)


def test_a_reference_checkpoint_restores_in_the_port_bit_equal(tmp_path):
    jst = _reference_f32_state()
    JCheckpointManager(str(tmp_path)).save(jst, 9)
    target = convert.train_state_from_numpy(
        jax.tree.map(lambda x: np.zeros_like(np.asarray(x)), jst), "cpu")
    got = CheckpointManager(str(tmp_path)).restore(target)
    assert isinstance(got["opt"], OptState)
    want = jax.tree_util.tree_flatten_with_path(jst)[0]
    flat = tree.flatten_with_path(got)
    assert len(flat) == len(want)
    for (path, t), (_, w) in zip(flat, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w), err_msg=path)


# ---------------------------------------------------------------------------
# The resilient loop
# ---------------------------------------------------------------------------


def _counting_step():
    def step_fn(state, batch):
        state["x"].add_(batch)                  # in place, as the port's
        return state, {"loss": state["x"][0].clone()}
    return step_fn


def test_resilient_loop_recovers(tmp_path):
    """Fault at step 7 -> restore from the checkpoint at 5 -> complete,
    with the replayed steps giving the uninterrupted result."""
    fired = {"done": False}

    def fault(step):
        if step == 7 and not fired["done"]:
            fired["done"] = True
            raise InjectedFault("runtime_error", "test-chaos")

    mgr = CheckpointManager(str(tmp_path))
    loop = ResilientLoop(_counting_step(), lambda s: torch.full((2,),
                                                                float(s)),
                         mgr, checkpoint_every=5, fault_hook=fault,
                         async_checkpoint=False)
    res = loop.run({"x": torch.zeros(2)}, 10)
    assert isinstance(res, LoopResult)
    assert res.final_step == 10 and res.restarts == 1
    assert res.faults_injected == 1
    final = mgr.restore({"x": torch.zeros(2)}, 10)
    np.testing.assert_array_equal(final["x"].numpy(),
                                  np.full(2, sum(range(10))))
    assert torch.equal(res.state["x"], final["x"])
    assert len(res.metrics_history) == 12   # steps 5 and 6 ran twice
    assert all(isinstance(v, float) for m in res.metrics_history
               for v in m.values())


def test_resilient_loop_gives_up(tmp_path):
    def fault(step):
        raise InjectedFault("runtime_error", "test-always")

    loop = ResilientLoop(lambda s, b: (s, {}), lambda s: None,
                         CheckpointManager(str(tmp_path)), max_restarts=2,
                         fault_hook=fault, async_checkpoint=False)
    with pytest.raises(InjectedFault):
        loop.run({"x": torch.zeros(1)}, 5)


def test_resilient_loop_shared_fault_seam(tmp_path):
    """faults="runtime=1.0,..." goes through the shared FaultSpec: an
    injection at every step until max_restarts is spent."""
    loop = ResilientLoop(lambda s, b: (s, {}), lambda s: None,
                         CheckpointManager(str(tmp_path)), max_restarts=2,
                         faults="runtime=1.0,seed=3", async_checkpoint=False)
    with pytest.raises(InjectedFault) as ei:
        loop.run({"x": torch.zeros(1)}, 5)
    assert ei.value.kind == "runtime_error"
    assert "train-step-0" in str(ei.value)


def test_resilient_loop_fault_env_resolution(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_FAULT_SPEC", "runtime=1.0,seed=3")
    mgr = CheckpointManager(str(tmp_path))
    loop = ResilientLoop(lambda s, b: (s, {}), lambda s: None, mgr,
                         max_restarts=1, faults=None,
                         async_checkpoint=False)
    with pytest.raises(InjectedFault):
        loop.run({"x": torch.zeros(1)}, 5)
    off = ResilientLoop(lambda s, b: (s, {}), lambda s: None, mgr,
                        faults=False, async_checkpoint=False)
    res = off.run({"x": torch.zeros(1)}, 5)
    assert res.final_step == 5 and res.faults_injected == 0


def test_resilient_loop_without_checkpoints_restarts_from_the_state():
    """ckpt=None: nothing is written; a drill goes on from the state as it
    is, at the first step, as the reference does before a checkpoint."""
    loop = ResilientLoop(_counting_step(), lambda s: torch.ones(1), None,
                         fault_hook=drill_at(2), async_checkpoint=False)
    res = loop.run({"x": torch.zeros(1)}, 4)
    assert res.final_step == 4 and res.restarts == 1
    assert float(res.state["x"][0]) == 6.0      # 2 steps, then 4 again


def test_straggler_monitor():
    mon = StragglerMonitor(threshold=3.0)
    for i in range(8):
        assert mon.record(i, 0.1) is None
    ev = mon.record(8, 1.0)
    assert ev is not None and ev.step == 8 and len(mon.events) == 1
