"""Sharding rules: logical axis names -> mesh partition specs.

The port of ``repro/parallel/sharding.py``.  Parallelism map:
  * batch        -> ("pod", "data") (whatever exists and divides)
  * TP (model)   -> d_ff, vocab, attention heads (when divisible), experts,
                    SSM heads
  * SP           -> KV sequence over "model" for archs whose KV head count
                    does not divide the model axis; KV-cache sequence over
                    ("data","model") for the batch=1 long-context shape
  * ZeRO-1       -> optimizer state additionally over "data"
                    (:func:`repro_torch.optim.adamw.zero1_specs`)

All rules degrade to replication when a dimension does not divide the mesh
axis, so a 1x1 mesh takes the same code path.  A spec is :class:`P`: one
entry a dimension, ``None`` (whole), an axis name, or a tuple of axis
names (the dimension cut over those axes, the first outermost).  The
reference hands its specs to GSPMD, which places tensors and derives the
collectives; here :mod:`repro_torch.parallel.collectives` cuts each leaf
to the block its rank's coordinates select under its spec and runs the
collectives itself.  Inside a layer nothing is split: :func:`constrain`
leaves an activation as it is, and the "model" axis splits where the
parameters and moments live, not a layer's arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

from repro_torch import tree as tree_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh


def _entry(e):
    """An entry as JAX keeps it: no axes -> None, one axis -> its name."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


class P(tuple):
    """A partition spec: ``P("data", None)``, one entry a dimension.  As
    JAX's ``PartitionSpec``, an entry of one axis is that axis' name and an
    entry of no axes is ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def mesh_axis_size(mesh: Mesh, name: str) -> int:
    return mesh.axis_sizes.get(name, 1)


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axes_size(mesh: Mesh, axes: Sequence[str]) -> int:
    n = 1
    for a in axes:
        n *= mesh_axis_size(mesh, a)
    return n


def _maybe(axis, dim_size: int, mesh: Mesh):
    """Return `axis` if dim_size divides the axis size, else None."""
    if axis is None:
        return None
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    sz = _axes_size(mesh, axes)
    if sz > 1 and dim_size % sz == 0:
        return axis
    return None


@dataclass(frozen=True)
class ShardingRules:
    """Resolved sharding decisions for one (arch, mesh, shape-kind)."""
    mesh: Mesh
    cfg: ModelConfig
    batch: Tuple[str, ...] = ()     # axes for the batch dim
    tp: str = "model"               # tensor-parallel axis
    attn_mode: str = "seq"          # "head" (KV heads TP) | "seq" (KV seq SP)
    kv_seq_axes: Tuple[str, ...] = ()   # axes sharding the KV-cache seq dim
    # seq mode with Q heads divisible by tp: shard wq/wo (and q
    # activations) over Q heads even though KV heads cannot shard
    q_heads_tp: bool = False

    # ---- parameter specs -------------------------------------------------
    def param_spec(self, path: str, shape: Tuple[int, ...]) -> P:
        """Spec for a parameter leaf. `path` is a '/'-joined name."""
        m, mesh = self.tp, self.mesh
        leaf = path.split("/")[-1]
        if leaf in ("embed", "unembed"):
            return P(_maybe(m, shape[0], mesh), None)    # (vocab, d_model)
        if leaf in ("wq", "wo"):
            # (D, H, hd) / (H, hd, D): shard flattened head dim when possible
            h_dim = 1 if leaf == "wq" else 0
            return self._head_spec(shape, h_dim)
        if leaf in ("wk", "wv"):
            return self._head_spec(shape, 1)
        if leaf in ("w_in", "w_gate"):
            return P(None, _maybe(m, shape[-1], mesh))   # (D, F)
        if leaf == "w_out":
            return P(_maybe(m, shape[0], mesh), None)    # (F, D)
        if leaf == "router":
            return P(None, None)
        if leaf in ("we_in", "we_gate"):                 # (E, D, F)
            return P(_maybe(m, shape[0], mesh), None, None)
        if leaf == "we_out":                             # (E, F, D)
            return P(_maybe(m, shape[0], mesh), None, None)
        if leaf == "w_zxbcdt":                           # (D, zxbcdt)
            return P(None, _maybe(m, shape[-1], mesh))
        if leaf == "w_ssm_out":                          # (d_inner, D)
            return P(_maybe(m, shape[0], mesh), None)
        if leaf == "conv_w":                             # (K, channels)
            return P(None, _maybe(m, shape[-1], mesh))
        if leaf in ("A_log", "dt_bias", "ssm_D"):        # (H,)
            return P(_maybe(m, shape[0], mesh))
        if leaf == "ssm_norm":                           # (d_inner,)
            return P(_maybe(m, shape[0], mesh))
        # norms, biases, small vectors: replicate
        return P(*([None] * len(shape)))

    def _head_spec(self, shape: Tuple[int, ...], h_dim: int) -> P:
        mesh = self.mesh
        spec = [None] * len(shape)
        if self.attn_mode == "head":
            spec[h_dim] = _maybe(self.tp, shape[h_dim], mesh)
        elif self.q_heads_tp and shape[h_dim] == self.cfg.n_heads:
            # wq/wo only (their head dim is n_heads; wk/wv have n_kv_heads
            # which does not divide tp in this mode)
            spec[h_dim] = _maybe(self.tp, shape[h_dim], mesh)
        return P(*spec)

    # ---- activation specs ------------------------------------------------
    def _b(self):
        return self.batch if self.batch else None

    def hidden_spec(self) -> P:
        """(B, S, D) residual-stream activations."""
        return P(self._b(), None, None)

    def ffn_spec(self) -> P:
        """(B, S, F) intermediate activations (TP over F)."""
        return P(self._b(), None, self.tp)

    def q_spec(self) -> P:
        """(B, S, H, hd)."""
        h = self.tp if self.attn_mode == "head" else None
        return P(self._b(), None, h, None)

    def kv_spec(self) -> P:
        """(B, S, KV, hd) — sequence-sharded in "seq" mode."""
        if self.attn_mode == "head":
            return P(self._b(), None, self.tp, None)
        s = self.kv_seq_axes if self.kv_seq_axes else None
        return P(self._b(), s, None, None)

    def kv_cache_spec(self) -> P:
        """(B, S, KV, hd) persistent cache."""
        return self.kv_spec()

    def logits_spec(self) -> P:
        """(B, S, V) — vocab TP."""
        return P(self._b(), None, self.tp)

    def blocked_q_spec(self, nb: int) -> P:
        """(B, nb, block, KV, G, hd): blocks over tp when they divide."""
        if self.attn_mode == "head":
            kv = self.cfg.n_kv_heads
            return P(self._b(), None, None,
                     _maybe(self.tp, kv, self.mesh), None, None)
        return P(self._b(), _maybe(self.tp, nb, self.mesh), None, None,
                 None, None)

    def blocked_kv_spec(self, nb: int) -> P:
        """(B, nb, ext, KV, hd)."""
        if self.attn_mode == "head":
            kv = self.cfg.n_kv_heads
            return P(self._b(), None, None,
                     _maybe(self.tp, kv, self.mesh), None)
        return P(self._b(), _maybe(self.tp, nb, self.mesh), None, None,
                 None)

    def q_seq_spec(self) -> P:
        """(B, S, H, hd) q activations for the one-shot train path:
        heads-TP when possible, else sequence-sharded."""
        if self.attn_mode == "head" or self.q_heads_tp:
            return P(self._b(), None, self.tp, None)
        return P(self._b(), self.tp, None, None)

    def kv_rep_spec(self) -> P:
        """(B, S, KV, hd) replicated over tp (gathered once per layer)."""
        if self.attn_mode == "head":
            return P(self._b(), None, self.tp, None)
        return P(self._b(), None, None, None)

    def ssm_state_spec(self) -> P:
        """(B, H, P, N) recurrent state — heads TP."""
        h = _maybe(self.tp, self.cfg.ssm.n_heads(self.cfg.d_model),
                   self.mesh) if self.cfg.ssm else self.tp
        return P(self._b(), h, None, None)

    def dispatch_spec(self) -> P:
        """(G, E, cap, D) MoE dispatch buffer — experts TP."""
        e = self.cfg.moe.n_experts if self.cfg.moe else 0
        return P(self._b(), _maybe(self.tp, e, self.mesh), None, None)


def make_rules(cfg: ModelConfig, mesh: Mesh, *, global_batch: int,
               shape_kind: str = "train") -> ShardingRules:
    if global_batch < 1:
        raise ValueError(f"make_rules: global_batch {global_batch} < 1")
    b_axes = []
    remaining = global_batch
    for a in batch_axes(mesh):
        sz = mesh_axis_size(mesh, a)
        if remaining % sz == 0 and remaining >= sz:
            b_axes.append(a)
            remaining //= sz
    tp_size = mesh_axis_size(mesh, "model")
    if cfg.n_kv_heads and tp_size > 1 and cfg.n_kv_heads % tp_size == 0:
        attn_mode = "head"
        kv_seq: Tuple[str, ...] = ()
        q_heads_tp = False
    else:
        attn_mode = "seq"
        kv_seq = ("model",) if tp_size > 1 else ()
        # batch=1 long-context: spread the KV sequence over spare batch axes
        unused = tuple(a for a in batch_axes(mesh) if a not in b_axes)
        kv_seq = unused + kv_seq
        q_heads_tp = bool(cfg.n_heads and tp_size > 1
                          and cfg.n_heads % tp_size == 0)
    return ShardingRules(mesh=mesh, cfg=cfg, batch=tuple(b_axes),
                         attn_mode=attn_mode, kv_seq_axes=kv_seq,
                         q_heads_tp=q_heads_tp)


def logical_to_spec(rules: ShardingRules, tree):
    """Map a parameter tree to a tree of specs by leaf path (the paths of
    :func:`repro_torch.tree.flatten_with_path`)."""
    return tree_mod.unflatten_like(
        tree, [rules.param_spec(path, tuple(leaf.shape))
               for path, leaf in tree_mod.flatten_with_path(tree)])


def constrain(x, mesh: Mesh, spec: P = None):
    """The reference's ``with_sharding_constraint`` wrapper.  Activations
    are not split here (a layer's arithmetic runs on whole local tensors),
    so the placement is the identity on every mesh."""
    return x
