"""Flash attention: the forward (K1, K3) and backward (K2a, K2b) CUDA kernels,
their plain versions, and the autograd Function around them.

Replaces the Pallas TPU kernels of ``diffbir_tpu/ops/flash_attention.py``:
``_kernel`` (K1, launched by ``_flash_attention_impl``, with its optional
logsumexp output) and ``_dq_kernel`` (K2a) + ``_dkv_kernel`` (K2b), launched by
``_flash_attention_bwd_impl``; ``flash_attention`` is the counterpart of its
``custom_vjp``. K3, the packed-layout forward ``_kernel_packed`` (launched by
``_flash_attention_impl_packed``), is K1 with one option, ``prescale_q``: in
bf16, q is rounded once as bf16(q * d^-1/2) and the logits are not scaled
again (``_kernel_packed`` l.243-250); in fp32 the option changes nothing, as
there. The packed kernel's [B,S,H*D] tiles are what K1 already reads through
strides, so K3 is a second entry point of the same kernels with its own
launch count, not a second kernel. It is forward-only: the JAX custom-VJP
forward always takes the folded kernel, and so does ``FlashAttention``. The
kernels are ``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``
(with the tensor-core tiles of ``csrc/wgmma_tile.cuh``), built for ``sm_90a``
at first use.

What bounds them on an H100: at the main path's shapes ([2,4096,5,64] in the
UNet at 512^2 when serving, [8,4096,5,64] when training) attention is
compute-bound, and the plain version's cost is the fp32 [B,H,Sq,Skv] logits
and probabilities it writes to and reads back from device memory (671 MB
each at [2,4096,5,64]; the backward's plain version holds four such
tensors). The kernels keep them on chip: the forward with an online softmax
over kv tiles, the backward by recomputing p = exp(s - lse) per tile from
the forward's saved fp32 logsumexp. They read q, k, v, o and dO through
their strides, so the projections' views go in without fold/unfold copies.
The forward does 2 and the backward 3 (K2a) and 4 (K2b) products of
2*Sq*Skv*d flops per head against a few MB of operands, so only the tensor
cores come near the bound. In bf16 at d = 64 and 128 (every site of the
UNet, the ControlNet and the vision tower, and every backward of the
training path) all four run on them: wgmma, bf16 tiles loaded with cp.async
in two stages, p and ds kept in registers as the next product's A operand
(entries ``flash_attention_fwd_tc`` / ``_fwd_prescaled_tc`` /
``_bwd_dq_tc`` / ``_bwd_dkv_tc``, counted on ``KERNEL_TC`` /
``KERNEL_PRESCALED_TC`` / ``KERNEL_DQ_TC`` / ``KERNEL_DKV_TC``). The K1
forward in bf16 at d = 512 (the VAE's single-head mid-block attention) has
a tensor-core design of its own (``flash_attention_fwd_wide_tc``, counted on
``KERNEL_WIDE_TC``): 64 query rows a block, o's 512 columns split over two
warpgroups. fp32 at any d, bf16 at d = 256, K3 at d = 512 and the backward
at d = 512 go to the CUDA-core entries (``KERNEL``, ``KERNEL_PRESCALED``,
``KERNEL_DQ``, ``KERNEL_DKV``): the tensor cores have no fp32 mode that
keeps fp32's limit, and no path of the port reaches the others: the VAE
never takes the packed layout, and RGB guidance's gradient through its
decoder goes to plain math below ``attention.FLASH_MIN_WIDE_GRAD`` tokens,
where the CUDA-core backward loses to it. ``fwd_entries`` and
``bwd_entries`` state the rule; nothing falls back from one entry to
another, and a tensor-core launch that fails raises.

Layouts: q, o, dO [B,Sq,H,D]; k, v [B,Skv,H,D]; lse fp32 [B,H,Sq] (not the
TPU's lane-replicated (BQ, 128) blocks).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ._cuda import CudaKernel
from .attention import FLASH_HEAD_DIMS, plain_attention

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_ptr = ctypes.c_void_p
_i32 = ctypes.c_int
_i64 = ctypes.c_longlong
_FWD_ARGS = [_ptr, _ptr, _ptr, _ptr, _ptr, _i32,
             _i32, _i32, _i32, _i32, _i32,
             _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64]
# each forward entry: its args, then (q_scale for the prescaled ones) the
# logits' scale and the stream
KERNEL = CudaKernel("flash_attention_fwd.cu", "flash_attention_fwd",
                    _FWD_ARGS + [ctypes.c_float, _ptr])
KERNEL_PRESCALED = CudaKernel("flash_attention_fwd.cu", "flash_attention_fwd_prescaled",
                              _FWD_ARGS + [ctypes.c_float, ctypes.c_float, _ptr])
KERNEL_TC = CudaKernel("flash_attention_fwd.cu", "flash_attention_fwd_tc",
                       _FWD_ARGS + [ctypes.c_float, _ptr])
KERNEL_PRESCALED_TC = CudaKernel("flash_attention_fwd.cu", "flash_attention_fwd_prescaled_tc",
                                 _FWD_ARGS + [ctypes.c_float, ctypes.c_float, _ptr])
KERNEL_WIDE_TC = CudaKernel("flash_attention_fwd.cu", "flash_attention_fwd_wide_tc",
                            _FWD_ARGS + [ctypes.c_float, _ptr])
KERNEL_DQ = CudaKernel(
    "flash_attention_bwd.cu",
    "flash_attention_bwd_dq",
    [_ptr] * 7 + [_i32] * 6 + [_ptr, ctypes.c_float, _ptr],
)
KERNEL_DKV = CudaKernel(
    "flash_attention_bwd.cu",
    "flash_attention_bwd_dkv",
    [_ptr] * 8 + [_i32] * 6 + [_ptr, ctypes.c_float, _ptr],
)
KERNEL_DQ_TC = CudaKernel(
    "flash_attention_bwd.cu",
    "flash_attention_bwd_dq_tc",
    [_ptr] * 7 + [_i32] * 6 + [_ptr, ctypes.c_float, _ptr],
)
KERNEL_DKV_TC = CudaKernel(
    "flash_attention_bwd.cu",
    "flash_attention_bwd_dkv_tc",
    [_ptr] * 8 + [_i32] * 6 + [_ptr, ctypes.c_float, _ptr],
)
# head dims of the tensor-core entries (bf16 only): KERNEL_TC and
# KERNEL_PRESCALED_TC, the backward's KERNEL_DQ_TC and KERNEL_DKV_TC; and of
# the wide forward KERNEL_WIDE_TC
TC_HEAD_DIMS = (64, 128)
WIDE_TC_HEAD_DIMS = (512,)


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        prescale_q: bool = False) -> torch.Tensor:
    """Plain version of K1 (and with ``prescale_q`` of K3): the same math as
    ``plain_attention`` without mask or bias; with ``prescale_q`` a bf16 q
    is rounded once as bf16(q * d^-1/2) and the logits are not scaled."""
    if prescale_q and q.dtype == torch.bfloat16:
        q = (q.float() * q.shape[-1] ** -0.5).to(torch.bfloat16)
        return plain_attention(q, k, v, scale=1.0)
    return plain_attention(q, k, v)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32 for bf16/fp32 inputs, as the kernels accumulate; float64 stays
    float64 so the CPU path can be gradient-checked."""
    return torch.promote_types(x.dtype, torch.float32)


def _logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """s = q.k^T * d^-1/2 as [B,H,Sq,Skv], accumulated in fp32 (or float64)."""
    acc = _acc_dtype(q)
    return torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * q.shape[-1] ** -0.5


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1 with its logsumexp: (o [B,Sq,H,D], lse [B,H,Sq]
    fp32), lse = logsumexp over kv of s = q.k^T * d^-1/2."""
    return flash_attention_ref(q, k, v), torch.logsumexp(_logits(q, k), dim=-1)


def _bwd_probs_ref(q, k, v, o, lse, g):
    """(p, ds) of the backward, [B,H,Sq,Skv] in fp32 (or float64), step by step
    as ``_dq_kernel``/``_dkv_kernel``."""
    acc = _acc_dtype(q)
    scale = q.shape[-1] ** -0.5
    p = torch.exp(_logits(q, k) - lse.to(acc)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", g.to(acc), v.to(acc))
    delta = (g.to(acc) * o.to(acc)).sum(-1).transpose(1, 2)  # [B,H,Sq]
    ds = p * (dp - delta[..., None]) * scale
    return p, ds


def _dq_from_ds(ds, k, dtype) -> torch.Tensor:
    """dq = sum_j ds->dtype * k, accumulated in fp32 (or float64)."""
    acc = _acc_dtype(k)
    return torch.einsum("bhqk,bkhd->bqhd", ds.to(dtype).to(acc), k.to(acc)).to(dtype)


def _dkv_from_probs(p, ds, q, g, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk = sum_i ds->dtype * q, dv = sum_i p->dtype * dO."""
    acc = _acc_dtype(q)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(dtype).to(acc), q.to(acc))
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dtype).to(acc), g.to(acc))
    return dk.to(dtype), dv.to(dtype)


def flash_attention_bwd_dq_ref(q, k, v, o, lse, g) -> torch.Tensor:
    """Plain version of K2a: dq = sum_j ds->dtype * k, in the input dtype."""
    _, ds = _bwd_probs_ref(q, k, v, o, lse, g)
    return _dq_from_ds(ds, k, q.dtype)


def flash_attention_bwd_dkv_ref(q, k, v, o, lse, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2b: dk = sum_i ds->dtype * q, dv = sum_i p->dtype *
    dO, in the input dtype."""
    p, ds = _bwd_probs_ref(q, k, v, o, lse, g)
    return _dkv_from_probs(p, ds, q, g, q.dtype)


def flash_attention_bwd_ref(q, k, v, o, lse, g):
    """Plain version of the backward: (dq, dk, dv) from the saved q, k, v, o,
    the forward's lse and the output gradient g; p and ds are formed once."""
    p, ds = _bwd_probs_ref(q, k, v, o, lse, g)
    return (_dq_from_ds(ds, k, q.dtype), *_dkv_from_probs(p, ds, q, g, q.dtype))


# --------------------------------------------------------------------------- #
# kernel wrappers: the plain version for a CPU tensor, the kernel for a CUDA
# tensor, an error for anything else
# --------------------------------------------------------------------------- #
def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes [B,S,H,D] tensors")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {FLASH_HEAD_DIMS}")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")


def _on_kernel_device(*ts: torch.Tensor) -> bool:
    """False for CPU tensors (plain version), True for CUDA tensors that the
    kernels take; raises on anything else."""
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"flash_attention tensors on different devices: {devices}")
    dev = ts[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {dev}")
    dtype = ts[0].dtype
    if dtype not in _DTYPE_CODES or any(t.dtype != dtype for t in ts):
        raise TypeError(f"flash_attention takes bf16 or fp32, got "
                        f"{', '.join(str(t.dtype) for t in ts)}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("flash_attention needs unit stride over the head dim")
    return True


def _strides(*ts: torch.Tensor) -> list:
    return [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]


def fwd_entries(q: torch.Tensor, prescale_q: bool = False) -> CudaKernel:
    """The forward entry for q's dtype and head dim: in bf16 the tensor-core
    K1 (``KERNEL_TC``; K3, ``KERNEL_PRESCALED_TC``, with ``prescale_q``) at d
    in ``TC_HEAD_DIMS`` and the wide tensor-core K1 (``KERNEL_WIDE_TC``) at d
    in ``WIDE_TC_HEAD_DIMS``; the CUDA-core K1 (``KERNEL``; K3,
    ``KERNEL_PRESCALED``) for fp32 at any d, for bf16 at d = 256, and for K3
    at d = 512."""
    bf16, d = q.dtype == torch.bfloat16, q.shape[-1]
    if prescale_q:
        return KERNEL_PRESCALED_TC if bf16 and d in TC_HEAD_DIMS else KERNEL_PRESCALED
    if bf16 and d in TC_HEAD_DIMS:
        return KERNEL_TC
    return KERNEL_WIDE_TC if bf16 and d in WIDE_TC_HEAD_DIMS else KERNEL


def launch_fwd(kernel: CudaKernel, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               with_lse: bool = False):
    """o (and with ``with_lse`` lse) from one forward entry on checked CUDA
    inputs; ``flash_attention_fwd`` picks the entry by ``fwd_entries``. A
    prescaled entry (K3) rounds a bf16 q once as bf16(q * d^-1/2) and leaves
    the logits unscaled; on fp32 it scales the logits as K1 does."""
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None,
            _DTYPE_CODES[q.dtype], b, h, sq, k.shape[1], d, *_strides(q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if kernel in (KERNEL_PRESCALED, KERNEL_PRESCALED_TC):
            bf16 = q.dtype == torch.bfloat16
            kernel.launch(*args, d ** -0.5 if bf16 else 1.0, 1.0 if bf16 else d ** -0.5, stream)
        else:
            kernel.launch(*args, d ** -0.5, stream)
    return (out, lse) if with_lse else out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        with_lse: bool = False, prescale_q: bool = False):
    """K1: o [B,Sq,H,D] (contiguous), and with ``with_lse`` also lse [B,H,Sq]
    fp32; with ``prescale_q`` K3 (q rounded once as bf16(q * d^-1/2), no
    lse). A CPU tensor goes to the plain version; a CUDA tensor launches the
    entry of ``fwd_entries`` or raises (bf16 or fp32, one dtype and device
    for all three, unit stride over D). For the tensor-core entries an
    operand whose rows are not 16-byte aligned is copied first (no path of
    the port makes one)."""
    _check(q, k, v)
    if with_lse and prescale_q:
        raise ValueError("the prescaled-q forward (K3) has no lse output")
    if not _on_kernel_device(q, k, v):
        if with_lse:
            return flash_attention_lse_ref(q, k, v)
        return flash_attention_ref(q, k, v, prescale_q=prescale_q)
    kernel = fwd_entries(q, prescale_q)
    if kernel in (KERNEL_TC, KERNEL_PRESCALED_TC, KERNEL_WIDE_TC):
        q, k, v = (t if _rows_aligned(t) else t.contiguous() for t in (q, k, v))
    return launch_fwd(kernel, q, k, v, with_lse)


def bwd_entries(q: torch.Tensor) -> Tuple[CudaKernel, CudaKernel]:
    """The (K2a, K2b) entries for q's dtype and head dim: the tensor-core
    entries for bf16 at d in ``TC_HEAD_DIMS``, the CUDA-core entries for fp32
    at any d and for bf16 at d = 256 and 512 (a d = 512 backward of the
    port's paths, RGB guidance's, takes plain math below
    ``FLASH_MIN_WIDE_GRAD`` tokens)."""
    if q.dtype == torch.bfloat16 and q.shape[-1] in TC_HEAD_DIMS:
        return KERNEL_DQ_TC, KERNEL_DKV_TC
    return KERNEL_DQ, KERNEL_DKV


def _rows_aligned(t: torch.Tensor) -> bool:
    """Every row of t starts on a 16-byte boundary (the tensor-core entries'
    copies move 16 bytes; bf16 strides in whole 8-element chunks)."""
    return t.data_ptr() % 16 == 0 and all(t.stride(i) % 8 == 0 for i in range(3))


def _bwd_inputs(q, k, v, o, lse, g):
    """Check the backward's inputs; returns (on the kernel device?, q, k, v,
    o, dO). Autograd may hand over any view as dO, which is read through its
    strides unless its head dim is strided, then copied. For the tensor-core
    entries an operand whose rows are not 16-byte aligned is copied too (no
    path of the port makes one: projections' views of 64-wide heads are
    aligned)."""
    _check(q, k, v)
    if o.shape != q.shape or g.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and dO {tuple(g.shape)} must match q "
                         f"{tuple(q.shape)}")
    b, sq, h, _ = q.shape
    if lse.shape != (b, h, sq):
        raise ValueError(f"lse must be [B,H,Sq], got {tuple(lse.shape)}")
    if g.stride(-1) != 1:
        g = g.contiguous()
    on_kernel = _on_kernel_device(q, k, v, o, g)
    if on_kernel and (lse.device != q.device or lse.dtype != torch.float32
                      or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous fp32 on {q.device}, got {lse.dtype} "
                         f"on {lse.device}")
    if on_kernel and bwd_entries(q)[0] is KERNEL_DQ_TC:
        q, k, v, o, g = (t if _rows_aligned(t) else t.contiguous() for t in (q, k, v, o, g))
    return on_kernel, (q, k, v, o, g)


def _bwd_launch(kernel: CudaKernel, q, k, v, o, lse, g, *outs: torch.Tensor) -> None:
    b, sq, h, d = q.shape
    strides = (_i64 * 15)(*_strides(q, k, v, o, g))
    with torch.cuda.device(q.device):
        kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                      g.data_ptr(), *(t.data_ptr() for t in outs), _DTYPE_CODES[q.dtype],
                      b, h, sq, k.shape[1], d, strides, d ** -0.5,
                      torch.cuda.current_stream(q.device).cuda_stream)


def launch_dq(kernel: CudaKernel, q, k, v, o, lse, g) -> torch.Tensor:
    """dq from one K2a entry (``KERNEL_DQ_TC`` or ``KERNEL_DQ``) on checked
    CUDA inputs; ``flash_attention_bwd_dq`` picks the entry by
    ``bwd_entries``."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch(kernel, q, k, v, o, lse, g, dq)
    return dq


def launch_dkv(kernel: CudaKernel, q, k, v, o, lse, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from one K2b entry, as ``launch_dq``."""
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _bwd_launch(kernel, q, k, v, o, lse, g, dk, dv)
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, g):
    """K2a + K2b: (dq, dk, dv) from the saved q, k, v, o, the forward's lse
    and the output gradient g (dO). dq [B,Sq,H,D] and dk, dv [B,Skv,H,D] are
    contiguous, in the input dtype; q, k, v, o and dO are read through their
    strides; lse is the forward's fp32 [B,H,Sq]. A CPU tensor goes to the
    plain version; a CUDA tensor launches both kernels (the entries of
    ``bwd_entries``) or raises."""
    on_kernel, (q, k, v, o, g) = _bwd_inputs(q, k, v, o, lse, g)
    if not on_kernel:
        return flash_attention_bwd_ref(q, k, v, o, lse, g)
    dq_kernel, dkv_kernel = bwd_entries(q)
    return (launch_dq(dq_kernel, q, k, v, o, lse, g),
            *launch_dkv(dkv_kernel, q, k, v, o, lse, g))


def flash_attention_bwd_dq(q, k, v, o, lse, g) -> torch.Tensor:
    """K2a alone (dq), inputs as ``flash_attention_bwd``."""
    on_kernel, (q, k, v, o, g) = _bwd_inputs(q, k, v, o, lse, g)
    if not on_kernel:
        return flash_attention_bwd_dq_ref(q, k, v, o, lse, g)
    return launch_dq(bwd_entries(q)[0], q, k, v, o, lse, g)


def flash_attention_bwd_dkv(q, k, v, o, lse, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2b alone (dk, dv), inputs as ``flash_attention_bwd``."""
    on_kernel, (q, k, v, o, g) = _bwd_inputs(q, k, v, o, lse, g)
    if not on_kernel:
        return flash_attention_bwd_dkv_ref(q, k, v, o, lse, g)
    return launch_dkv(bwd_entries(q)[1], q, k, v, o, lse, g)


class FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX ``custom_vjp``: the forward saves q, k, v, o and
    the fp32 lse; the backward runs K2a and K2b over them (on the CPU, the two
    plain versions)."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, o, lse, g)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    prescale_q: bool = False) -> torch.Tensor:
    """q [B,Sq,H,D]; k, v [B,Skv,H,D] -> [B,Sq,H,D] (contiguous), differentiable.

    Where no gradient is needed (serving, or inputs that need none) this is
    one K1 launch without lse (K3 with ``prescale_q``); otherwise K1 with lse
    under the autograd Function, whose backward launches K2a and K2b
    (``prescale_q`` is then ignored, as the JAX custom-VJP forward ignores
    the packed layout)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v)
    return flash_attention_fwd(q, k, v, prescale_q=prescale_q)
