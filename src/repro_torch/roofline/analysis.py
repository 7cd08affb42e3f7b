"""Roofline analysis of a traced step on the H100.

Three terms per (arch x shape x mesh), each in seconds a step on one
card:

    compute    = FLOPs_per_card  / PEAK_FLOPS   (dense bf16 tensor cores)
    memory     = HBM_bytes       / HBM_BW
    collective = wire_bytes      / LINK_BW      (NVLink 4, one direction)

The constants are the published figures of the H100 SXM5 80GB, the card
``nvidia-smi`` names "NVIDIA H100 80GB HBM3" (700 W): 989.4 TFLOP/s of
dense bf16, 3.35 TB/s of HBM3 and 450 GB/s a direction over NVLink 4
(900 GB/s both ways). A group that spans hosts (InfiniBand) is not
modelled: every group is taken to sit on NVLink, as the reference takes
every group to sit on its torus.

The FLOPs, bytes and collectives come from `StepCounter`, a dispatch
mode that sees the local (per-rank) ops of a DTensor program traced on
fake tensors: the FLOPs of each op by ``torch.utils.flop_counter``'s
formulas, its operand and result bytes, and every functional collective
(``all_gather_into_tensor``, ``all_reduce``, ``reduce_scatter_tensor``,
``all_to_all_single``) with its result bytes and group size, fed to
`record_collective`. Its ring model of wire bytes a card:

    all-reduce      2·bytes·(n-1)/n        all-gather  out·(n-1)/n
    reduce-scatter  out·(n-1)              all-to-all  out·(n-1)/n
    collective-permute  bytes
"""

from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

PEAK_FLOPS = 989.4e12        # dense bf16 / card
HBM_BW = 3.35e12             # bytes/s / card
LINK_BW = 450e9              # bytes/s / direction (NVLink 4)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
               "all-to-all", "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0          # ring-model bytes per card
    payload_bytes: float = 0.0       # raw result bytes
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    by_kind_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)


def record_collective(stats: CollectiveStats, kind: str,
                      result_bytes: int, group_size: int) -> None:
    """Add one collective of ``kind`` (one of `COLLECTIVES`) whose result
    is ``result_bytes`` on a group of ``group_size`` ranks; an empty
    result is not counted."""
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}")
    bytes_ = int(result_bytes)
    if bytes_ == 0:
        return
    n = max(1, int(group_size))
    ring = (n - 1) / n if n > 1 else 0.0
    if kind == "all-reduce":
        wire = 2.0 * bytes_ * ring
    elif kind == "all-gather":
        wire = bytes_ * ring            # bytes_ = gathered result
    elif kind == "reduce-scatter":
        wire = bytes_ * ring * n        # result is the shard
    elif kind == "all-to-all":
        wire = bytes_ * ring
    else:                               # collective-permute
        wire = float(bytes_)
    stats.wire_bytes += wire
    stats.payload_bytes += bytes_
    stats.counts[kind] = stats.counts.get(kind, 0) + 1
    stats.by_kind_bytes[kind] = stats.by_kind_bytes.get(kind, 0.0) + wire


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: DTensor's sharding propagation runs each new op once on fake tensors
#: of the *global* shape to learn its result's shape; ops called from
#: these frames are not a rank's work
_META_FRAMES = frozenset(("_propagate_tensor_meta_non_cached",
                          "_propagate_tensor_meta", "gen_fake_args",
                          "_rebuild_tensor_from_dtensor_meta"))


def _in_meta_propagation(depth: int = 12) -> bool:
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        if f.f_code.co_name in _META_FRAMES:
            return True
        f = f.f_back
    return False


#: op namespaces that move no data of their own: the collectives' waits
#: and metadata queries (``prim.device``)
_NO_BYTES = frozenset(("_c10d_functional", "prim"))


def _funcol_ops():
    """``{functional collective op: (kind, group size of its args)}``."""
    c = torch.ops._c10d_functional
    return {
        c.all_gather_into_tensor.default:
            ("all-gather", lambda a: a[1]),
        c.all_reduce.default: ("all-reduce", lambda a: _group_size(a[2])),
        c.all_reduce_.default: ("all-reduce", lambda a: _group_size(a[2])),
        c.reduce_scatter_tensor.default:
            ("reduce-scatter", lambda a: a[2]),
        c.all_to_all_single.default:
            ("all-to-all", lambda a: _group_size(a[3])),
    }


class StepCounter(TorchDispatchMode):
    """Counts what one rank does in a step: enter it inside the
    ``FakeTensorMode`` (and below any mode that must see DTensors). An op
    on DTensors is passed on (``NotImplemented``) to DTensor, whose local
    ops come back here on plain (fake) tensors (the global-shape ops of
    DTensor's own shape propagation are passed over):

    - ``flops``: ``torch.utils.flop_counter``'s count of each local op;
    - ``bytes``: each local op's operand and result bytes, views,
      collectives, their waits and metadata queries excepted;
    - ``coll``: the functional collectives (`record_collective`);
    - ``peak_bytes``: the peak of the live bytes of the storages made
      while the mode is on (a storage counts until it is freed).
    """

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self._coll_ops = _funcol_ops()
        self._wait = torch.ops._c10d_functional.wait_tensor.default
        self.flops = 0
        self.bytes = 0
        self.coll = CollectiveStats()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen = weakref.WeakSet()

    def exclude(self, tensors) -> None:
        """Storages that exist before the step (its arguments): never
        counted, views of them neither."""
        for t in tensors:
            self._seen.add(t.untyped_storage())

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            self._seen.add(st)
            n = st.nbytes()
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_meta_propagation():
            return out
        coll = self._coll_ops.get(func)
        if coll is not None:
            kind, group = coll
            record_collective(self.coll, kind, _nbytes(out), group(args))
        elif not func.is_view and func.namespace not in _NO_BYTES:
            self.bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs,
                                                               out))
                              if isinstance(t, torch.Tensor))
            formula = self._flops_of.get(func._overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
        if func is not self._wait:      # aliases its input on a card
            self._track(out)
        return out


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    wire_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float               # 6·N·D (active) per card-step
    useful_ratio: float              # MODEL_FLOPS / traced FLOPs
    collectives: CollectiveStats

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("collectives")
        d["collective_counts"] = self.collectives.counts
        d["collective_by_kind"] = self.collectives.by_kind_bytes
        return d


def analyze(flops: float, hbm_bytes: float, coll: CollectiveStats, *,
            chips: int, model_flops_total: float) -> Roofline:
    """The three terms of one card's step and the largest of them."""
    flops = float(flops)
    hbm = float(hbm_bytes)
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm / HBM_BW
    collective_s = coll.wire_bytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf_chip = model_flops_total / chips
    return Roofline(
        flops_per_chip=flops, hbm_bytes_per_chip=hbm,
        wire_bytes_per_chip=coll.wire_bytes,
        compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, bottleneck=bottleneck,
        model_flops=mf_chip,
        useful_ratio=mf_chip / flops if flops else 0.0,
        collectives=coll)


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N_active·D for training, 2·N_active·D for
    inference (D = tokens processed in the step)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch                  # one token per sequence
    return 2.0 * n_active * tokens


# --------------------------------------------------------------------
# Analytic FLOP model: 2 FLOPs per active matmul parameter per token,
# plus attention score/weight terms, x3 for the backward pass in
# training, from the configuration alone.

def analytic_flops(cfg, shape) -> float:
    """Total step FLOPs across the cluster (not per card)."""
    from repro_torch.models.decoder import ffn_kind, layer_kind
    hd = cfg.hd
    H, KV = cfg.n_heads, cfg.n_kv_heads
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab
    L = cfg.n_layers

    # per-layer matmul params (active)
    def layer_params(j: int) -> float:
        p = 0.0
        kind = layer_kind(cfg, j % max(1, _period(cfg)))
        if kind in ("attn", "cross"):
            p += d * H * hd + 2 * d * KV * hd + H * hd * d
        elif kind == "mamba":
            di = cfg.ssm_expand * d
            p += 2 * d * di + di * 2 * cfg.ssm_state + di * d
        elif kind == "mlstm":
            p += 3 * d * H * hd + H * hd * d + d * H * hd
        elif kind == "slstm":
            p += 4 * d * H * hd + H * hd * 4 * hd + H * hd * d
        fk = ffn_kind(cfg, j % max(1, _period(cfg)))
        g = 2 if cfg.act == "swiglu" else 1
        if fk == "mlp":
            p += d * g * f + f * d
        elif fk == "moe":
            p += d * cfg.moe_experts                  # router
            p += cfg.moe_topk * (d * g * f + f * d)   # active experts
        return p

    n_matmul = sum(layer_params(j) for j in range(L))
    n_matmul += d * V                                  # unembed

    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens, mult, s_eff = B * S, 3.0, S / 2
    elif shape.kind == "prefill":
        tokens, mult, s_eff = B * S, 1.0, S / 2
    else:                                              # decode
        tokens, mult, s_eff = B * 1, 1.0, S

    flops = 2.0 * n_matmul * tokens * mult
    # attention scores + weighted sum: 4·s_eff·H·hd per attn layer/token
    n_attn = sum(1 for j in range(L)
                 if _kind_of(cfg, j) in ("attn", "cross"))
    flops += 4.0 * s_eff * H * hd * n_attn * tokens * mult
    if cfg.family == "encdec":
        # encoder over audio tokens (self) + decoder cross-attention
        enc_tokens = B * cfg.n_audio_tokens
        flops += 2.0 * (cfg.enc_layers * (d * H * hd * 2 + 2 * d * KV
                                          * hd + d * 2 * f + f * d)
                        ) * enc_tokens * mult
    return flops


def _period(cfg) -> int:
    from repro_torch.models.decoder import period
    return period(cfg)


def _kind_of(cfg, j) -> str:
    from repro_torch.models.decoder import layer_kind
    return layer_kind(cfg, j % max(1, _period(cfg)))
