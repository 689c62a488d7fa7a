"""The Mamba-2 language model's configuration and weights as the port
takes them (``repro_torch.models.mamba``'s leaves, stacked under
``scan/p0``), by views of the benchmark's weights."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, SSMConfig

from portbench.adapters.moe_decoder import check_layout


def port_config(cfg: dict) -> ModelConfig:
    return ModelConfig(
        name=cfg["name"], family="ssm", n_layers=cfg["n_layer"],
        d_model=cfg["d_model"], n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0,
        vocab_size=cfg["vocab_size"], tie_embeddings=cfg["tie_embeddings"],
        norm_eps=cfg["rms_norm_eps"],
        ssm=SSMConfig(d_state=cfg["d_state"], d_conv=cfg["d_conv"],
                      expand=cfg["expand"], head_dim=cfg["headdim"],
                      n_groups=cfg["ngroups"], chunk=cfg["chunk_size"]),
        param_dtype=cfg["param_dtype"], compute_dtype=cfg["param_dtype"],
        source=cfg["source"])


def port_params(cfg: dict, w: dict) -> dict:
    pc = port_config(cfg)
    if pc.padded_vocab != cfg["padded_vocab_size"]:
        raise ValueError(f"padded vocabulary {cfg['padded_vocab_size']} is "
                         f"not the port's {pc.padded_vocab}")
    lw = w["layers"]
    params = {"embed": w["embed"], "final_norm": w["final_norm"],
              "scan": {"p0": {"ln1": lw["norm"], "ssm": {
                  "w_zxbcdt": lw["in_proj"], "conv_w": lw["conv_w"],
                  "conv_b": lw["conv_b"], "A_log": lw["A_log"],
                  "dt_bias": lw["dt_bias"], "ssm_D": lw["D"],
                  "ssm_norm": lw["ssm_norm"],
                  "w_ssm_out": lw["out_proj"]}}}}
    check_layout(pc, params)
    return params


# the port's leaf of each of the benchmark's layer leaves, for the checks
PORT_LEAF = {"norm": "ln1", "in_proj": "w_zxbcdt", "conv_w": "conv_w",
             "conv_b": "conv_b", "A_log": "A_log", "dt_bias": "dt_bias",
             "D": "ssm_D", "ssm_norm": "ssm_norm", "out_proj": "w_ssm_out"}


def flat(w: dict) -> dict:
    """The benchmark's weights by name (``layers.<leaf>`` stacked)."""
    out = {"embed": w["embed"], "final_norm": w["final_norm"]}
    out.update({f"layers.{k}": v for k, v in w["layers"].items()})
    return out


def canonical(tree: dict) -> dict:
    """A tree in the port's layout (parameters or a moment) by the
    benchmark's names."""
    layer = tree["scan"]["p0"]
    ssm = layer["ssm"]
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    for name, leaf in PORT_LEAF.items():
        out[f"layers.{name}"] = layer["ln1"] if leaf == "ln1" else ssm[leaf]
    return out
