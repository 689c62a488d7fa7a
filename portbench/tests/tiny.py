"""Cells of the benchmark at a size a CPU test holds: the cells'
configurations and mixes with every size cut, float32, on the CPU."""
from __future__ import annotations

import copy

from portbench import harness

SERVE_SIZES = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                   num_key_value_heads=4, head_dim=16, intermediate_size=32,
                   num_experts=8, num_experts_per_tok=2, vocab_size=250,
                   padded_vocab_size=256, torch_dtype="float32")
TRAIN_SIZES = dict(n_layer=2, d_model=64, d_state=16, headdim=16,
                   chunk_size=8, vocab_size=250, padded_vocab_size=256,
                   param_dtype="float32")

# limits far above a float32 run's rounding and far below the faults'
LIMITS = {"token_gap_mean": 1e-4, "logits_rel_rms_median": 1e-3,
          "grad_gap": 1e-3, "change_gap": 1e-2}


def cell(workload: str) -> harness.Cell:
    c = harness.load_cell(workload)
    c = copy.deepcopy(c)
    if c.traffic["kind"] == "serve":
        c.config.update(SERVE_SIZES)
        c.traffic.update(prompt_len=24, warmup_requests=1,
                         trace_requests=2, check_requests=3, check_block=8)
        c.traffic["arrival"]["rate_per_s"] = 1000.0
    else:
        c.config.update(TRAIN_SIZES)
        c.traffic.update(batch=4, seq_len=16, loss_chunk=8, batch_pool=6,
                         check_block=5)
    c.limits = {k: LIMITS[k] for k in c.limits}
    return c
