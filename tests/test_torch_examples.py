"""The port's example twins run on the CPU with ``--device cpu``.

``examples/torch/quickstart.py`` and
``examples/torch/characterize_and_place.py`` are the twins of the JAX
package's two examples; each defaults to the card
and, asked for it where there is none, exits non-zero.  Each runs as its
own process, as a user runs it.
"""
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _run(name, *args):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch", name),
         *args], capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))


def test_quickstart_runs_on_the_cpu():
    proc = _run("quickstart.py", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "== detected memory pools (device tree: h100-sxm, cpu) ==" in out
    assert "pool 0: hbm" in out and "pool 1: host" in out
    curve = [ln.split() for ln in out.splitlines()
             if ln.strip() and ln.split()[0].isdigit()]
    assert [int(c[0]) for c in curve] == list(range(8))
    bws = [float(c[1]) for c in curve]
    assert all(b > 0 for b in bws) and bws[-1] < bws[0]
    assert "Little's law @ worst case:" in out and "MLP ~=" in out


def test_characterize_and_place_runs_on_the_cpu():
    proc = _run("characterize_and_place.py", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    for step in range(1, 6):
        assert f"== {step}. " in out, step
    assert "curves collected: 36" in out
    assert "hbm       (l,r)x(r,r)" in out and "host      (l,w)x(r,w)" in out
    assert "surfaces: 4; 'hbm:l|hbm:b' grid shape (8, 3, 3)" in out
    m = re.search(r"6 iterations -> (\d+) ladder launches \((\d+) "
                  r"re-measured\), 24 probes", out)
    assert m and int(m.group(1)) == 6 + int(m.group(2))
    assert "executed=True, fenced=True" in out
    assert "installed envelope 'hbm:l|hbm:b#worstcase'" in out
    assert "installed envelope 'hbm:r|hbm:b#worstcase'" in out
    assert "pessimistic placement, 7 stressors of any mix:" in out
    arms = [ln.split()[3] for ln in out.splitlines()
            if ln.strip().startswith("iteration ")]
    assert sorted(arms[:4]) == sorted(["b", "y", "t/st8", "t/st64"])
    assert len(arms) == 6


@pytest.mark.parametrize("name", ["quickstart.py",
                                  "characterize_and_place.py"])
def test_examples_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal cannot be shown")
    proc = _run(name)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
