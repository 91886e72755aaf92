"""Tensor parallelism of the diffusion stack over processes, one card each.

Counterpart of ``diffbir_tpu/parallel/tp.py``. ``tp_dim`` is ``tp_spec``'s
rule on torch state-dict names and layouts: column-parallel (output
features, dim 0 of a Linear [out, in] or a Conv [out, in, kh, kw]) for
q/k/v, the FF in-projections and ``emb_layers.1``/``in_layers.2``;
row-parallel (input features, dim 1) for the out-projections, ``net.2``
and ``out_layers.3``; a leaf whose dimension does not divide by the process
count, and every other leaf, replicated.

Under JAX the rule is all there is: GSPMD places each leaf and inserts the
collectives, and ``jax.grad`` differentiates through them. Here
``tp_shard_`` slices this process's part of each weight in place and runs
the collectives itself (``parallel/collectives.py``), so a forward after it
computes what it did before, and a backward the same gradients, the
sharded weights' as this process's slices of them. Megatron's convention:
a column layer takes its replicated input through *f* (identity forward,
the input gradient all-reduced backward), a row layer reduces its partial
sums through *g* (all-reduce forward, identity backward). A unit left
replicated runs neither. An explicit forward needs rules that GSPMD made
unnecessary; each changes where a weight lives, never a number
(``tp_plan`` gives every leaf's placement and the reason):

- **pairs**: a column layer and its row partner are sharded together or
  not at all (``to_q``/``to_k``/``to_v`` with ``to_out.0``; ``net.0.proj``
  with ``net.2``; ``in_layers.2`` and ``emb_layers.1`` with
  ``out_layers.3``; the CLIP tower's ``mlp.c_fc`` with ``mlp.c_proj``;
  SwinIR's ``attn.qkv`` with ``attn.proj`` and ``mlp.fc1`` with
  ``mlp.fc2``).
  JAX's per-leaf divisibility may shard one side and replicate the other,
  and it row-shards the CLIP tower's ``attn.out_proj``, whose q/k/v
  projection (``in_proj_weight``) it leaves whole: both stay replicated;
- **whole heads**: attention is sharded by whole heads only (SD2.1 has 5
  heads at its first level, so at 2 processes that level's attention stays
  replicated; SwinIR's 6 heads shard over 2 and 3 processes, not 4);
  GSPMD may split a head. SwinIR's window attention also takes its heads'
  columns of the relative-position bias table (replicated under JAX);
- **whole GroupNorm groups**: ``out_layers.0`` normalises the
  channel-sharded activations, so a ResBlock shards only where each
  process holds whole groups (32 % n == 0);
- **GEGLU's interleave**: the projection's output is ``[x | gate]``, so a
  process takes matching slices of both halves, not one half; SwinIR's
  ``qkv`` likewise takes matching slices of its q, k and v thirds;
- **one reduce per row layer**: a row layer's partial sums are all-reduced
  once (in fp32), then its bias is added once;
- **one *f* per unit input**: an attention unit takes x (and its context)
  through *f* once for q, k and v, a feed-forward unit once for its GEGLU
  projection; a ResBlock's ``in_layers.2`` and ``emb_layers.1`` each take
  theirs, since the block's input also feeds its skip connection.

A sharded parameter keeps its ``requires_grad`` and carries its placement:
``tp_dim`` (the dimension) and ``tp_splits`` (2 for GEGLU's projection,
whose slices of the x and gate halves are laid side by side, 3 for
SwinIR's ``qkv``; else 1), which
``tp_whole`` and ``tp_local`` read to gather the whole tensor or take this
process's slice of one (``train/optim.py``: masters, moments, checkpoints).

The serving modes (``ControlLDM.set_mode``) place their units as JAX's
``tp_spec`` places their leaves, which shards only ``…/kernel`` leaves:

- **int8**: a unit that holds an int8 layer (``QuantLinear``, ``QuantConv``)
  stays whole ("int8"), as JAX leaves ``kernel_q`` and ``scale`` whole, and
  K4 runs on whole weights. In the int8 mode every attention, FFN and
  ResBlock unit of the UNet and the ControlNet is int8, so tensor
  parallelism then shards only the CLIP tower, which the modes leave float;
- **fused**: a ResBlock or FeedForward whose ``fused`` is set stays whole
  ("fused"): K6 and K7 read whole weights, which is what JAX's gathers
  around its ``pallas_call`` compute. An attention unit in the packed layout
  is sharded by whole heads as in the default mode: K3 runs per head.

The hoisted tables (``ControlLDM.make_hoist_tables``) made after
``tp_shard_`` hold this process's heads and channels: their cross-attention
k/v and ``emb_layers`` rows come from the sharded weights. The training
step makes none. Without a process group, or with one process (JAX: a
tensor axis of 1), it changes nothing.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.layers import Conv2d, GroupNorm32, Linear, QuantConv, QuantLinear
from ..models.swinir import WindowAttention
from ..models.unet import CrossAttention, FeedForward, ResBlock
from .collectives import CopyToTensorParallel, ReduceFromTensorParallel, all_gather

# column-parallel (shard dim 0 = output features); JAX's _COL_SUFFIXES
_COL_SUFFIXES = ("to_q", "to_k", "to_v", "net.0.proj", "in_layers.2", "qkv",
                 "mlp.c_fc", "mlp.fc1", "emb_layers.1")
# row-parallel (shard dim 1 = input features); JAX's _ROW_SUFFIXES
_ROW_SUFFIXES = ("to_out.0", "net.2", "out_layers.3", "proj", "mlp.c_proj",
                 "mlp.fc2")
# tp_plan's reasons for a placement
REASONS = ("col", "row", "geglu", "qkv", "replicated", "heads", "groups", "pair", "int8",
           "fused")


def tp_dim(name: str, weight: torch.Tensor, n: int) -> Optional[int]:
    """The dimension JAX's ``tp_spec`` shards the torch leaf ``name``
    (``.``-separated state-dict name, torch layout) along over ``n``
    processes, or None where it replicates it."""
    if not name.endswith(".weight") or weight.dim() < 2:
        return None
    base = name[: -len(".weight")]
    col = any(base.endswith(s) for s in _COL_SUFFIXES)
    row = any(base.endswith(s) for s in _ROW_SUFFIXES) and not col
    if col and weight.shape[0] % n == 0:
        return 0
    if row and weight.shape[1] % n == 0:
        return 1
    return None


# --------------------------------------------------------------------------- #
# the units: a column layer (or two) and its row partner
# --------------------------------------------------------------------------- #
# the (column, row) layers of each kind of two-layer MLP, a ModuleDict
_MLP_KEYS = {"mlp": ("c_fc", "c_proj"), "swin_mlp": ("fc1", "fc2")}


def _units(module: nn.Module) -> Iterator[Tuple[str, str, nn.Module]]:
    """(kind, prefix, module) of every shardable unit under ``module``:
    "attn" (CrossAttention), "ff" (FeedForward), "res" (ResBlock), "mlp"
    (the CLIP tower's MLP), "win" (SwinIR's WindowAttention), "swin_mlp"
    (SwinIR's MLP)."""
    for prefix, m in module.named_modules():
        if isinstance(m, CrossAttention):
            yield "attn", prefix, m
        elif isinstance(m, FeedForward):
            yield "ff", prefix, m
        elif isinstance(m, ResBlock):
            yield "res", prefix, m
        elif isinstance(m, WindowAttention):
            yield "win", prefix, m
        elif isinstance(m, nn.ModuleDict):
            for kind, keys in _MLP_KEYS.items():
                if set(m.keys()) == set(keys):
                    yield kind, prefix, m


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


# (column, row) weight names of each kind of unit, relative to it
_UNIT_LEAVES = {
    "attn": (("to_q.weight", "to_k.weight", "to_v.weight"), ("to_out.0.weight",)),
    "ff": (("net.0.proj.weight",), ("net.2.weight",)),
    "res": (("in_layers.2.weight", "emb_layers.1.weight"), ("out_layers.3.weight",)),
    "mlp": (("c_fc.weight",), ("c_proj.weight",)),
    "win": (("qkv.weight",), ("proj.weight",)),
    "swin_mlp": (("fc1.weight",), ("fc2.weight",)),
}


def _unit_blocker(kind: str, m: nn.Module, n: int) -> Optional[str]:
    """Why a unit stays replicated at ``n`` processes ("int8", "fused",
    "heads", "groups", "pair"), or None where it shards."""
    if any(isinstance(c, (QuantLinear, QuantConv)) for c in m.modules()):
        return "int8"
    if kind in ("ff", "res") and m.fused:
        return "fused"
    if kind == "attn":
        return None if m.heads % n == 0 else "heads"
    if kind == "win":
        return None if m.num_heads % n == 0 else "heads"
    if kind == "ff":
        return None if (m.net[0].proj.out_features // 2) % n == 0 else "pair"
    if kind == "res":
        if not isinstance(m.in_layers[2], Conv2d) or m.in_layers[2].out_channels % n:
            return "pair"
        return None if GroupNorm32.num_groups % n == 0 else "groups"
    return None if m[_MLP_KEYS[kind][0]].out_features % n == 0 else "pair"


def _weights(module: nn.Module) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every parameter of ``module``, and every int8 weight buffer
    (``weight_q``, ``weight_scale``: JAX's ``kernel_q`` and ``scale``)."""
    yield from module.named_parameters()
    for name, b in module.named_buffers():
        if name.rpartition(".")[2] in ("weight_q", "weight_scale"):
            yield name, b


def tp_plan(module: nn.Module, n: int) -> Dict[str, Tuple[Optional[int], str]]:
    """Every parameter and int8 weight of ``module``: (the dimension
    ``tp_shard_`` shards it along over ``n`` processes or None, the reason:
    one of ``REASONS``). Where the dimension differs from ``tp_dim``'s, the
    reason says why: "fused", "heads", "groups" or "pair"; "geglu" and
    "qkv" mark the interleaved column slices of a GEGLU projection and of
    SwinIR's qkv projection. The int8 weights of a unit are placed whole
    under "int8", as ``tp_dim`` (JAX's ``tp_spec``) places them."""
    plan = {}
    for name, p in _weights(module):
        d = tp_dim(name, p, n)
        plan[name] = (None, "replicated") if d is None else (None, "pair")
    for kind, prefix, m in _units(module):
        cols, rows = _UNIT_LEAVES[kind]
        blocker = _unit_blocker(kind, m, n)
        for leaf, dim in [(c, 0) for c in cols] + [(r, 1) for r in rows]:
            name = _join(prefix, leaf)
            if blocker is not None:
                if name in plan and tp_dim(name, module.get_parameter(name), n) is not None:
                    plan[name] = (None, blocker)
                for quantised in (name + "_q", name + "_scale"):  # weight_q, weight_scale
                    if quantised in plan:
                        plan[quantised] = (None, blocker)
                continue
            reason = "row" if dim else {"ff": "geglu", "win": "qkv"}.get(kind, "col")
            plan[name] = (dim, reason)
            if dim == 0:  # a column layer's bias goes with its rows
                bias = _join(prefix, leaf[: -len("weight")] + "bias")
                if bias in plan:
                    plan[bias] = (0, reason)
        if blocker is None and kind == "res":
            for leaf in ("out_layers.0.weight", "out_layers.0.bias"):
                plan[_join(prefix, leaf)] = (0, "groups")
        if blocker is None and kind == "win":
            plan[_join(prefix, "relative_position_bias_table")] = (1, "heads")
    return plan


# --------------------------------------------------------------------------- #
# the sharded layers
# --------------------------------------------------------------------------- #
def _reduce_partial(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the processes of a row layer's partial sums (fp32): *g*."""
    return ReduceFromTensorParallel.apply(t, group)


class _ColumnLinear(Linear):
    """A column layer's Linear (``emb_layers.1``, the CLIP tower's
    ``mlp.c_fc``): its input through *f*."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(CopyToTensorParallel.apply(x, self.tp_group))


class _ColumnConv2d(Conv2d):
    """``in_layers.2``: its input through *f*."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(CopyToTensorParallel.apply(x, self.tp_group))


class _ColumnAttention(CrossAttention):
    """An attention unit of this process's heads: x through *f* once for q,
    k and v, the context once for k and v."""

    def forward(self, x, context=None, kv=None):
        return super().forward(CopyToTensorParallel.apply(x, self.tp_group), context, kv)

    def context_kv(self, context: torch.Tensor) -> torch.Tensor:
        return super().context_kv(CopyToTensorParallel.apply(context, self.tp_group))


class _ColumnFeedForward(FeedForward):
    """A feed-forward unit of this process's GEGLU columns: x through *f*."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(CopyToTensorParallel.apply(x, self.tp_group))


class _ColumnWindowAttention(WindowAttention):
    """SwinIR's window attention of this process's heads: x through *f*
    once for q, k and v."""

    def forward(self, x, window, mask):
        return super().forward(CopyToTensorParallel.apply(x, self.tp_group), window, mask)


def _column_(module: nn.Module, cls: type, group) -> None:
    """``module`` (of ``cls``'s base class) in place as ``cls``, on ``group``."""
    module.__class__ = cls
    module.tp_group = group


def _placed(p: nn.Parameter, dim: int, splits: int = 1) -> nn.Parameter:
    """``p``, marked as this process's tensor slice along ``dim``."""
    p.tp_dim, p.tp_splits = dim, splits
    return p


class RowParallelLinear(nn.Module):
    """A Linear whose ``weight`` holds this process's input features: the
    partial product, one all-reduce of it in fp32 (*g*), the whole bias
    once."""

    def __init__(self, lin: nn.Linear, part: slice, group):
        super().__init__()
        self.weight = _placed(nn.Parameter(lin.weight.detach()[:, part].contiguous(),
                                           requires_grad=lin.weight.requires_grad), 1)
        self.bias = lin.bias
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _reduce_partial(F.linear(x.to(self.weight.dtype), self.weight).float(), self.group)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(self.weight.dtype)


class RowParallelConv2d(nn.Module):
    """A Conv2d whose ``weight`` holds this process's input channels, as
    ``RowParallelLinear``."""

    def __init__(self, conv: nn.Conv2d, part: slice, group):
        super().__init__()
        self.weight = _placed(nn.Parameter(conv.weight.detach()[:, part].contiguous(),
                                           requires_grad=conv.weight.requires_grad), 1)
        self.bias = conv.bias
        self.stride, self.padding = conv.stride, conv.padding
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.weight.dtype), self.weight, None, self.stride, self.padding)
        y = _reduce_partial(y.float(), self.group)
        if self.bias is not None:
            y = y + self.bias.float()[:, None, None]
        return y.to(self.weight.dtype)


def _keep_(p: nn.Parameter, idx: torch.Tensor, splits: int = 1) -> nn.Parameter:
    """The rows ``idx`` of ``p`` as a new parameter, placed along dim 0."""
    return _placed(nn.Parameter(p.detach()[idx].contiguous(), requires_grad=p.requires_grad),
                   0, splits)


def _rows_(layer: nn.Module, idx: torch.Tensor, splits: int = 1) -> None:
    """Keep the output features ``idx`` of a Linear or Conv2d in place."""
    layer.weight = _keep_(layer.weight, idx, splits)
    if layer.bias is not None:
        layer.bias = _keep_(layer.bias, idx, splits)
    if isinstance(layer, nn.Linear):
        layer.out_features = len(idx)
    else:
        layer.out_channels = len(idx)


def _part(size: int, rank: int, n: int) -> torch.Tensor:
    """This process's contiguous slice of ``size`` features, as indices."""
    per = size // n
    return torch.arange(rank * per, (rank + 1) * per)


def _span(idx: torch.Tensor) -> slice:
    return slice(int(idx[0]), int(idx[-1]) + 1)


def _shard_unit_(kind: str, m: nn.Module, rank: int, n: int, group) -> None:
    if kind == "attn":
        inner = m.to_q.out_features
        idx = _part(inner, rank, n)
        for lin in (m.to_q, m.to_k, m.to_v):
            _rows_(lin, idx)
        m.to_out[0] = RowParallelLinear(m.to_out[0], _span(idx), group)
        m.heads //= n
        _column_(m, _ColumnAttention, group)
    elif kind == "ff":
        proj = m.net[0].proj
        inner = proj.out_features // 2
        idx = _part(inner, rank, n)
        _rows_(proj, torch.cat([idx, idx + inner]), splits=2)  # matching x and gate slices
        m.net[2] = RowParallelLinear(m.net[2], _span(idx), group)
        _column_(m, _ColumnFeedForward, group)
    elif kind == "res":
        c = m.in_layers[2].out_channels
        idx = _part(c, rank, n)
        _rows_(m.in_layers[2], idx)
        _rows_(m.emb_layers[1], idx)
        _column_(m.in_layers[2], _ColumnConv2d, group)
        _column_(m.emb_layers[1], _ColumnLinear, group)
        gn = m.out_layers[0]
        gn.weight, gn.bias = _keep_(gn.weight, idx), _keep_(gn.bias, idx)
        gn.num_groups = GroupNorm32.num_groups // n  # whole groups on each process
        m.out_layers[3] = RowParallelConv2d(m.out_layers[3], _span(idx), group)
        m._tap_major.clear()
    elif kind == "win":
        dim = m.proj.in_features
        idx = _part(dim, rank, n)  # whole heads: num_heads % n == 0
        _rows_(m.qkv, torch.cat([idx, idx + dim, idx + 2 * dim]), splits=3)
        m.proj = RowParallelLinear(m.proj, _span(idx), group)
        table = m.relative_position_bias_table
        heads = _part(m.num_heads, rank, n)
        m.relative_position_bias_table = _placed(nn.Parameter(
            table.detach()[:, heads].contiguous(), requires_grad=table.requires_grad), 1)
        m.num_heads //= n
        _column_(m, _ColumnWindowAttention, group)
    else:
        fc, proj = _MLP_KEYS[kind]
        idx = _part(m[fc].out_features, rank, n)
        _rows_(m[fc], idx)
        _column_(m[fc], _ColumnLinear, group)
        m[proj] = RowParallelLinear(m[proj], _span(idx), group)


# each kind of unit's column layer, which ``_column_`` marks with its group
_COLUMN_OF = {"attn": lambda m: m, "ff": lambda m: m, "res": lambda m: m.in_layers[2],
              "mlp": lambda m: m["c_fc"], "win": lambda m: m, "swin_mlp": lambda m: m["fc1"]}


@torch.no_grad()
def tp_shard_(module: nn.Module, group=None) -> nn.Module:
    """Shard ``module`` (a ControlLDM, or any module holding its UNet,
    ControlNet or CLIP blocks, or a SwinIR) over the processes of ``group`` (default:
    the whole process group) in place, by ``tp_plan``: this process keeps
    its slices (each parameter its ``requires_grad``), the column layers
    take their input through *f* and the row layers reduce through *g*.
    A unit sharded already is left as it is. Returns ``module``. Without a
    process group, or at one process, nothing changes. Any serving mode:
    its int8 and fused units stay whole (see the module's notes)."""
    if not dist.is_initialized():
        return module
    n = dist.get_world_size(group)
    if n == 1:
        return module
    rank = dist.get_rank(group)
    for kind, _, m in list(_units(module)):
        if not hasattr(_COLUMN_OF[kind](m), "tp_group") and _unit_blocker(kind, m, n) is None:
            _shard_unit_(kind, m, rank, n, group)
    return module


# --------------------------------------------------------------------------- #
# whole tensors from the slices, and back
# --------------------------------------------------------------------------- #
def tp_local(full: torch.Tensor, dim: int, splits: int, rank: int, n: int) -> torch.Tensor:
    """This process's slice of the whole ``full`` by a parameter's placement
    (``tp_dim``, ``tp_splits``): of each of the ``splits`` parts along
    ``dim``, the ``rank``-th of ``n`` equal slices, side by side."""
    return torch.cat([part.chunk(n, dim)[rank] for part in full.chunk(splits, dim)],
                     dim).contiguous()


def tp_whole(local: torch.Tensor, dim: int, splits: int, group) -> torch.Tensor:
    """The whole tensor from every process's ``tp_local`` slice (one
    all-gather over ``group``; no backward)."""
    parts = [p.chunk(splits, dim) for p in all_gather(local, group)]
    return torch.cat([p[i] for i in range(splits) for p in parts], dim).contiguous()
