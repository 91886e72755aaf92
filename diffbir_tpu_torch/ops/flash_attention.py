"""Flash attention: the forward (K1) and backward (K2a, K2b) CUDA kernels,
their plain versions, and the autograd Function around them.

Replaces the Pallas TPU kernels of ``diffbir_tpu/ops/flash_attention.py``:
``_kernel`` (K1, launched by ``_flash_attention_impl``, with its optional
logsumexp output) and ``_dq_kernel`` (K2a) + ``_dkv_kernel`` (K2b), launched by
``_flash_attention_bwd_impl``; ``flash_attention`` is the counterpart of its
``custom_vjp``. The kernels are ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu``, built for ``sm_90a`` at first use.

What bounds them on an H100: at the main path's shapes ([2,4096,5,64] in the
UNet at 512^2 when serving, [8,4096,5,64] when training, [1,4096,1,512] in
the VAE) attention is compute-bound, and the plain version's cost is the fp32
[B,H,Sq,Skv] logits and probabilities it writes to and reads back from device
memory (671 MB each at [2,4096,5,64]; the backward's plain version holds four
such tensors). The kernels keep them on chip: the forward with an online
softmax over kv tiles, the backward by recomputing p = exp(s - lse) per tile
from the forward's saved fp32 logsumexp. They read q, k, v, o and dO through
their strides, so the projections' views go in without fold/unfold copies.
This first version runs every product as fp32 FMAs on the CUDA cores; moving
them to tensor cores (wgmma) is later work.

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
KERNEL = CudaKernel(
    "flash_attention_fwd.cu",
    "flash_attention_fwd",
    [_ptr, _ptr, _ptr, _ptr, _ptr, _i32,
     _i32, _i32, _i32, _i32, _i32,
     _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64,
     ctypes.c_float, _ptr],
)
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


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: the same math as ``plain_attention`` without
    mask or bias."""
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


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        with_lse: bool = False):
    """K1: o [B,Sq,H,D] (contiguous), and with ``with_lse`` also lse [B,H,Sq]
    fp32. A CPU tensor goes to the plain version; a CUDA tensor launches the
    kernel or raises (bf16 or fp32, one dtype and device for all three, unit
    stride over D)."""
    _check(q, k, v)
    if not _on_kernel_device(q, k, v):
        return flash_attention_lse_ref(q, k, v) if with_lse else flash_attention_ref(q, k, v)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        KERNEL.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None,
            _DTYPE_CODES[q.dtype], b, h, sq, skv, d, *_strides(q, k, v),
            d ** -0.5, stream,
        )
    return (out, lse) if with_lse else out


def _bwd_inputs(q, k, v, o, lse, g):
    """Check the backward's inputs; returns (on the kernel device?, dO with a
    unit-stride head dim: autograd may hand over any view, which is read
    through its strides unless its head dim is strided, then copied)."""
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
    return on_kernel, g


def _bwd_launch(kernel: CudaKernel, q, k, v, o, lse, g, *outs: torch.Tensor) -> None:
    b, sq, h, d = q.shape
    strides = (_i64 * 15)(*_strides(q, k, v, o, g))
    with torch.cuda.device(q.device):
        kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                      g.data_ptr(), *(t.data_ptr() for t in outs), _DTYPE_CODES[q.dtype],
                      b, h, sq, k.shape[1], d, strides, d ** -0.5,
                      torch.cuda.current_stream(q.device).cuda_stream)


def _launch_dq(q, k, v, o, lse, g) -> torch.Tensor:
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch(KERNEL_DQ, q, k, v, o, lse, g, dq)
    return dq


def _launch_dkv(q, k, v, o, lse, g) -> Tuple[torch.Tensor, torch.Tensor]:
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _bwd_launch(KERNEL_DKV, q, k, v, o, lse, g, dk, dv)
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, g):
    """K2a + K2b: (dq, dk, dv) from the saved q, k, v, o, the forward's lse
    and the output gradient g (dO). dq [B,Sq,H,D] and dk, dv [B,Skv,H,D] are
    contiguous, in the input dtype; q, k, v, o and dO are read through their
    strides; lse is the forward's fp32 [B,H,Sq]. A CPU tensor goes to the
    plain version; a CUDA tensor launches both kernels or raises."""
    on_kernel, g = _bwd_inputs(q, k, v, o, lse, g)
    if not on_kernel:
        return flash_attention_bwd_ref(q, k, v, o, lse, g)
    return (_launch_dq(q, k, v, o, lse, g), *_launch_dkv(q, k, v, o, lse, g))


def flash_attention_bwd_dq(q, k, v, o, lse, g) -> torch.Tensor:
    """K2a alone (dq), inputs as ``flash_attention_bwd``."""
    on_kernel, g = _bwd_inputs(q, k, v, o, lse, g)
    if not on_kernel:
        return flash_attention_bwd_dq_ref(q, k, v, o, lse, g)
    return _launch_dq(q, k, v, o, lse, g)


def flash_attention_bwd_dkv(q, k, v, o, lse, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2b alone (dk, dv), inputs as ``flash_attention_bwd``."""
    on_kernel, g = _bwd_inputs(q, k, v, o, lse, g)
    if not on_kernel:
        return flash_attention_bwd_dkv_ref(q, k, v, o, lse, g)
    return _launch_dkv(q, k, v, o, lse, g)


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [B,Sq,H,D]; k, v [B,Skv,H,D] -> [B,Sq,H,D] (contiguous), differentiable.

    Where no gradient is needed (serving, or inputs that need none) this is
    one K1 launch without lse; otherwise K1 with lse under the autograd
    Function, whose backward launches K2a and K2b."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v)
    return flash_attention_fwd(q, k, v)
