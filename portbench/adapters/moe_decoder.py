"""The MoE decoder's configuration and weights as the port takes them.

:func:`port_config` builds ``repro_torch``'s :class:`ModelConfig` from the
configuration file; :func:`port_params` maps the benchmark's weights onto
the port's parameter tree (``repro_torch.models.lm``'s layout: the layers
stacked under ``scan/p0``), by views where the layouts agree.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import lm


def port_config(cfg: dict) -> ModelConfig:
    if not cfg["norm_topk_prob"]:
        raise ValueError("the port renormalises the top-k gates: "
                         "norm_topk_prob must be true")
    return ModelConfig(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=0, vocab_size=cfg["vocab_size"], rope_theta=cfg["rope_theta"],
        qkv_bias=cfg["attention_bias"],
        tie_embeddings=cfg["tie_word_embeddings"], act_fn=cfg["hidden_act"],
        norm_eps=cfg["rms_norm_eps"],
        moe=MoEConfig(n_experts=cfg["num_experts"],
                      top_k=cfg["num_experts_per_tok"],
                      d_ff_expert=cfg["intermediate_size"]),
        param_dtype=cfg["torch_dtype"], compute_dtype=cfg["torch_dtype"],
        source=cfg["source"])


def port_params(cfg: dict, w: dict) -> dict:
    pc = port_config(cfg)
    if pc.padded_vocab != cfg["padded_vocab_size"]:
        raise ValueError(f"padded vocabulary {cfg['padded_vocab_size']} is "
                         f"not the port's {pc.padded_vocab}")
    lw = w["layers"]
    L, D = lw["ln1"].shape
    H, KV, hd = pc.n_heads, pc.n_kv_heads, pc.head_dim
    params = {"embed": w["embed"], "final_norm": w["final_norm"]}
    if "unembed" in w:
        params["unembed"] = w["unembed"]
    params["scan"] = {"p0": {
        "ln1": lw["ln1"],
        "attn": {"wq": lw["wq"].view(L, D, H, hd),
                 "wk": lw["wk"].view(L, D, KV, hd),
                 "wv": lw["wv"].view(L, D, KV, hd),
                 "wo": lw["wo"].view(L, H, hd, D)},
        "ln2": lw["ln2"],
        "moe": {"router": lw["router"], "we_in": lw["w_up"],
                "we_gate": lw["w_gate"], "we_out": lw["w_down"]},
    }}
    check_layout(pc, params)
    return params


def check_layout(pc: ModelConfig, params: dict) -> None:
    """The tree's paths, shapes and dtypes, in order, are the port's own
    (``lm.param_struct``): the train step pairs leaves by their order."""
    from repro_torch import tree
    want = [(p, tuple(t.shape), t.dtype)
            for p, t in tree.flatten_with_path(lm.param_struct(pc))]
    have = [(p, tuple(t.shape), t.dtype)
            for p, t in tree.flatten_with_path(params)]
    if want != have:
        diff = [(a, b) for a, b in zip(want, have) if a != b][:3]
        raise ValueError(f"parameter tree differs from the port's: {diff} "
                         f"({len(want)} leaves wanted, {len(have)} given)")
