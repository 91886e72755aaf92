"""Fused ResBlock: the conv-weight quantiser, the CUDA kernel (K6), its plain
version, and the autograd Function around it.

Counterpart of ``diffbir_tpu/ops/fused_resblock.py``: K6 replaces its Pallas
TPU kernel ``_kernel`` (launched by ``_pallas_fused_resblock``) and is
``csrc/fused_resblock.cu``, built for ``sm_90a`` at first use, with two
entries: the tensor-core one (``KERNEL_TC``) for bf16, and the CUDA-core one
(``KERNEL``) for fp32, whose products the bf16 tensor cores do not give
(``resblock_entries`` states the rule). One call computes a whole UNet
ResBlock,

    h1  = conv3x3(SiLU(GN1(x))) + b1 + e
    out = skip(x) + conv3x3(SiLU(GN2(h1))) + b2,   skip = x or conv1x1(x) + b_skip,

in the Pallas kernel's rounding points (not those of its XLA fallback, which
adds the biases in the input dtype): the GN affine a, b in fp32, cast to the
dtype; x * a and + b each in the dtype; SiLU in fp32 and back; conv sums in
fp32, times the int8 scale when quantised, + bias + e in fp32; h1 cast to
the dtype before GN2; the skip in fp32; one final cast.

Layout, NCHW as the port's modules: x [B, Cin, H, W], e [B, Cout] (the
timestep projection). ``p`` has the JAX package's keys: gn1_scale, gn1_bias,
gn2_scale, gn2_bias; float mode w1, w2 (and w_skip) in PyTorch's OIHW layout
with b1, b2 (b_skip); int8 mode w1_q, w2_q (w_skip_q) int8 in the JAX HWIO
layout with fp32 per-output-channel scales s1, s2 (s_skip). The CUDA-core
entry reads both layouts in place; the tensor-core entry reads the int8
weights in place and the float ones in HWIO too: ``p`` may carry them as
w1_t, w2_t (w_skip_t), which ``ResBlock.fused_params`` keeps, repacked once
per weight version (``tap_major``); without them each call repacks. Biases
and e enter in x's dtype (the serving model's), the GN affine parameters in
fp32.

Every ResBlock of the model goes through K6 in the fused mode; the JAX
package's v5e dispatch tables and environment switches are not carried over.
The float mode is differentiable as in JAX (a custom VJP whose backward
recomputes the plain math); the int8 mode serves only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import gn_fold_moments
from ._cuda import CudaKernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("fused_resblock.cu", "fused_resblock",
                    [_ptr] * 18 + [_i32] * 8 + [ctypes.c_float, _ptr])
KERNEL_TC = CudaKernel("fused_resblock.cu", "fused_resblock_tc",
                       [_ptr] * 21 + [_i32] * 7 + [ctypes.c_float, _i32, _i32, _ptr])
TC_STAGE = 64  # channels per 64-deep K stage of the tensor-core convs
TC_MAX_GROUP_CHANNELS = 128
TC_MIN_STAGES = 18  # stages per K split: two 64-channel slices of the 9 taps


def quantize_conv_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float conv kernel (..., Cout), HWIO -> (int8 of the same shape, fp32
    scale [Cout]), symmetric per output channel over the taps and Cin:
    scale = max(amax, 1e-12) / 127 (not ``quantize_weight``'s formula), round
    half to even, clip to +-127 (the JAX ``quantize_conv_weight``, bit for
    bit). The result is contiguous whatever w's strides (an OIHW weight
    permuted to HWIO keeps them through ``.float()``, and K6 would copy a
    strided int8 tensor at every call)."""
    wf = w.float().contiguous()
    amax = wf.abs().amax(dim=tuple(range(wf.dim() - 1)))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def _quant(p: Dict[str, torch.Tensor]) -> bool:
    return "w1_q" in p


def _has_skip(p: Dict[str, torch.Tensor]) -> bool:
    return p.get("w_skip_q" if _quant(p) else "w_skip") is not None


def resblock_entries(x: torch.Tensor) -> CudaKernel:
    """The K6 entry for x: the tensor-core one (``KERNEL_TC``) for bf16, the
    CUDA-core one (``KERNEL``) for fp32."""
    return KERNEL_TC if x.dtype == torch.bfloat16 else KERNEL


@functools.lru_cache(maxsize=None)
def resblock_splits(m: int, cout: int, cs: int, sms: int) -> int:
    """Parts of one tensor-core conv's 3x3 K range (9 taps x 64-channel
    slices of its Cs input channels) over M = B*H*W pixels: enough blocks
    (128 x 128 tiles) for one per SM, at least TC_MIN_STAGES stages a part;
    every part non-empty."""
    total = 9 * -(-cs // TC_STAGE)
    tiles = -(-m // 128) * -(-cout // 128)
    splits = max(1, min(-(-sms // tiles), total // TC_MIN_STAGES))
    return -(-total // -(-total // splits))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tap_major(w: torch.Tensor) -> torch.Tensor:
    """A float conv weight, OIHW -> HWIO (contiguous, detached): the
    tensor-core entry's layout, the int8 mode's."""
    return w.detach().permute(2, 3, 1, 0).contiguous()


# --------------------------------------------------------------------------- #
# plain version
# --------------------------------------------------------------------------- #
def _silu_gn(v: torch.Tensor, scale, bias, groups: int, eps: float, acc) -> torch.Tensor:
    """SiLU(GroupNorm(v)) at the kernel's rounding points, in v's dtype."""
    dt = v.dtype
    vf = v.to(acc)
    s1 = vf.mean(dim=(2, 3))
    d = vf - s1[..., None, None]
    v_c = (d * d).mean(dim=(2, 3))
    a, b = gn_fold_moments(s1, v_c, scale.to(acc), bias.to(acc), groups, eps)
    t = v * a.to(dt)[..., None, None] + b.to(dt)[..., None, None]  # two roundings to dt
    tf = t.to(acc)
    return (tf * torch.sigmoid(tf)).to(dt)


def _conv(y: torch.Tensor, p: Dict[str, torch.Tensor], name: str, acc) -> torch.Tensor:
    """fp32 (or float64) conv sum of y with weight ``name`` (w1, w2,
    w_skip), times its int8 scale in the quantised mode."""
    quant = _quant(p)
    if quant:
        w = p[name + "_q"].to(acc).permute(3, 2, 0, 1)  # HWIO -> OIHW
    else:
        w = p[name].to(y.dtype).to(acc)
    out = F.conv2d(y.to(acc), w, padding=w.shape[-1] // 2)
    if quant:
        out = out * p[{"w1": "s1", "w2": "s2", "w_skip": "s_skip"}[name]].to(acc)[:, None, None]
    return out


def fused_resblock_ref(x: torch.Tensor, e: torch.Tensor, p: Dict[str, torch.Tensor],
                       groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of K6: x [B, Cin, H, W], e [B, Cout] -> [B, Cout, H, W]
    in x's dtype (float64 stays float64, for gradient checks)."""
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)

    def vec(name):  # a bias in the dtype, per channel, in the accumulator type
        return p[name].to(dt).to(acc)[:, None, None]

    y1 = _silu_gn(x, p["gn1_scale"], p["gn1_bias"], groups, eps, acc)
    h1 = _conv(y1, p, "w1", acc) + vec("b1") + e.to(dt).to(acc)[..., None, None]
    h1 = h1.to(dt)
    y2 = _silu_gn(h1, p["gn2_scale"], p["gn2_bias"], groups, eps, acc)
    h2 = _conv(y2, p, "w2", acc) + vec("b2")
    skip = _conv(x, p, "w_skip", acc) + vec("b_skip") if _has_skip(p) else x.to(acc)
    return (skip + h2).to(dt)


# --------------------------------------------------------------------------- #
# kernel wrapper
# --------------------------------------------------------------------------- #
def _operands(x, e, p, dev, dt):
    """(x, e, weights, scales, biases, GN params) of a CUDA call: the weights
    checked, the vectors in their types, everything contiguous."""
    quant, skip = _quant(p), _has_skip(p)
    wdt = torch.int8 if quant else dt

    def weight(name):
        t = p[name + "_q" if quant else name]
        if t.device != dev or t.dtype != wdt:
            raise TypeError(f"fused_resblock: {name} must be {wdt} on {dev}, got "
                            f"{t.dtype} on {t.device}")
        return t.contiguous()

    def vec(name, dtype):
        return p[name].to(dev, dtype).contiguous() if name in p else None

    ws = (weight("w1"), weight("w2"), weight("w_skip") if skip else None)
    scales = ((vec("s1", torch.float32), vec("s2", torch.float32),
               vec("s_skip", torch.float32) if skip else None) if quant else (None,) * 3)
    biases = (vec("b1", dt), vec("b2", dt), vec("b_skip", dt) if skip else None)
    gn = [vec(k, torch.float32) for k in ("gn1_scale", "gn1_bias", "gn2_scale", "gn2_bias")]
    return x.contiguous(), e.to(dt).contiguous(), ws, scales, biases, gn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned(t):
    if t is None or t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def launch_resblock(kernel: CudaKernel, x: torch.Tensor, e: torch.Tensor,
                    p: Dict[str, torch.Tensor], groups: int = 32, eps: float = 1e-5,
                    splits: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One K6 call through ``kernel`` on CUDA inputs (``fused_resblock``
    picks it by ``resblock_entries``); ``splits`` overrides the tensor-core
    convs' K splits (``resblock_splits``)."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_resblock takes bf16 or fp32, got {x.dtype}")
    quant, skip = _quant(p), _has_skip(p)
    dt, dev = x.dtype, x.device
    bsz, cin, h, w = x.shape
    cout = e.shape[1]
    if kernel is KERNEL_TC:
        if dt != torch.bfloat16:
            raise TypeError(f"the tensor-core fused_resblock takes bf16, got {dt}")
        if (cin % 8 or cout % 16 or cin % groups or cout % groups
                or max(cin, cout) // groups > TC_MAX_GROUP_CHANNELS):
            raise ValueError(f"the tensor-core fused_resblock takes Cin % 8 == 0, Cout % 16 == 0 "
                             f"and at most {TC_MAX_GROUP_CHANNELS} channels a group; got "
                             f"{cin} -> {cout} in {groups} groups")
        if not quant:  # the HWIO copies the module keeps, else repacked here
            p = dict(p)
            for name in ("w1", "w2", "w_skip"):
                if p.get(name) is not None and p.get(name + "_t") is None:
                    p[name + "_t"] = tap_major(p[name])
    elif kernel is not KERNEL:
        raise ValueError(f"not a K6 entry: {kernel.symbol}")
    x, e, ws, scales, biases, gn = _operands(x, e, p, dev, dt)
    out = torch.empty((bsz, cout, h, w), dtype=dt, device=dev)
    h1 = torch.empty_like(out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kernel is KERNEL:
        stats = torch.empty(2 * bsz * (cin + cout), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            KERNEL.launch(
                _ptr(x), _ptr(e), _ptr(gn[0]), _ptr(gn[1]), _ptr(ws[0]), _ptr(scales[0]),
                _ptr(biases[0]), _ptr(gn[2]), _ptr(gn[3]), _ptr(ws[1]), _ptr(scales[1]),
                _ptr(biases[1]), _ptr(ws[2]), _ptr(scales[2]), _ptr(biases[2]), _ptr(h1),
                _ptr(stats), _ptr(out), _DTYPE_CODES[dt], int(quant), bsz, cin, cout, h, w,
                groups, eps, stream)
        return out
    if not quant:
        ws = tuple(None if t is None else p[n + "_t"].contiguous()
                   for t, n in zip(ws, ("w1", "w2", "w_skip")))
    x = _aligned(x)
    ws = tuple(_aligned(t) for t in ws)
    m = bsz * h * w
    if splits is None:
        sms = _sm_count(dev.index)
        splits = (resblock_splits(m, cout, cin, sms), resblock_splits(m, cout, cout, sms))
    stats = torch.empty(2 * bsz * max(cin, cout), dtype=torch.float32, device=dev)
    y = torch.empty(m * max(cin, cout), dtype=dt, device=dev)
    xt = torch.empty(m * cin, dtype=dt, device=dev) if skip else None
    planes = max(splits[0], splits[1] + int(skip))
    part = (torch.empty(planes * cout * (-(-m // 4) * 4), dtype=torch.float32, device=dev)
            if planes > 1 else None)
    with torch.cuda.device(dev):
        KERNEL_TC.launch(
            _ptr(x), _ptr(e), _ptr(gn[0]), _ptr(gn[1]), _ptr(ws[0]), _ptr(scales[0]),
            _ptr(biases[0]), _ptr(gn[2]), _ptr(gn[3]), _ptr(ws[1]), _ptr(scales[1]),
            _ptr(biases[1]), _ptr(ws[2]), _ptr(scales[2]), _ptr(biases[2]), _ptr(h1),
            _ptr(stats), _ptr(y), _ptr(xt), _ptr(part), _ptr(out), int(quant), bsz, cin, cout,
            h, w, groups, eps, splits[0], splits[1], stream)
    return out


class FusedResBlock(torch.autograd.Function):
    """K6 forward (float mode); the backward differentiates the recomputed
    plain version (the JAX custom VJP's ``_diff_bwd``)."""

    @staticmethod
    def forward(ctx, x, e, names, groups, eps, *values):
        ctx.names, ctx.groups, ctx.eps = names, groups, eps
        ctx.save_for_backward(x, e, *values)
        p = dict(zip(names, values))
        return launch_resblock(resblock_entries(x), x, e, p, groups, eps)

    @staticmethod
    def backward(ctx, g):
        needs = (ctx.needs_input_grad[:2] + ctx.needs_input_grad[5:])
        inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = fused_resblock_ref(inputs[0], inputs[1], dict(zip(ctx.names, inputs[2:])),
                                     ctx.groups, ctx.eps)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g))
        grads = [next(grads) if t.requires_grad else None for t in inputs]
        return (grads[0], grads[1], None, None, None, *grads[2:])


def fused_resblock(x: torch.Tensor, e: torch.Tensor, p: Dict[str, torch.Tensor],
                   groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """One ResBlock, x [B, Cin, H, W] -> [B, Cout, H, W] (see the module's
    notes for ``p``). A CPU tensor goes to the plain version; a CUDA tensor
    launches the K6 entry of ``resblock_entries`` or raises. The float mode
    is differentiable."""
    quant = _quant(p)
    w1 = p["w1_q"] if quant else p["w1"]
    cout, cin = (w1.shape[3], w1.shape[2]) if quant else w1.shape[:2]
    if x.dim() != 4 or x.shape[1] != cin or e.shape != (x.shape[0], cout):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, e {tuple(e.shape)}, "
                         f"w1 {tuple(w1.shape)}")
    if not _has_skip(p) and cin != cout:
        raise ValueError(f"identity skip needs Cin == Cout, got {cin} -> {cout}")
    if x.device.type == "cpu":
        return fused_resblock_ref(x, e, p, groups, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_resblock: no kernel for device {x.device}")
    names = tuple(k for k, v in p.items() if v is not None)
    values = tuple(p[k] for k in names)
    if (not quant and torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, e, *values))):
        return FusedResBlock.apply(x, e, names, groups, eps, *values)
    return launch_resblock(resblock_entries(x), x, e, p, groups, eps)
