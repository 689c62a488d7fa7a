"""End-to-end training example: a reduced qwen2 on synthetic data with a
checkpoint/restart fault drill, microbatching and the MEMSCOPE placement
advisory — the whole training stack.  The twin of
``examples/train_tiny_lm.py`` on the PyTorch/CUDA port: runs on the card,
or on the CPU with ``--device cpu``.

    PYTHONPATH=src python examples/torch/train_tiny_lm.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile

from repro_torch.launch import train

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
ap.add_argument("--ckpt-dir", default=os.path.join(
    tempfile.gettempdir(), "repro_torch_example_ckpt"))
args = ap.parse_args()

sys.exit(train.main([
    "--arch", "qwen2-1.5b", "--reduced",
    "--steps", "60",
    "--batch", "8", "--seq", "64",
    "--microbatches", "2",
    "--lr", "3e-3",
    "--checkpoint-every", "20",
    "--ckpt-dir", args.ckpt_dir,
    "--inject-fault-at", "30",      # chaos drill: recover from step-20 ckpt
    "--log-every", "15",
    "--device", args.device,
]))
