"""Flash-attention forward (K1): a hand-written CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``diffbir_tpu/ops/flash_attention.py::_kernel``
(launched by ``_flash_attention_impl``). The kernel is
``csrc/flash_attention_fwd.cu``, built for ``sm_90a`` at first use.

What bounds it on an H100: at the main path's shapes ([2,4096,5,64] in the
UNet at 512^2, [1,4096,1,512] in the VAE) attention is compute-bound, and the
plain version's cost is the fp32 [B,H,S,S] logits and probabilities it writes
to and reads back from device memory (671 MB each at [2,4096,5,64]). The kernel
keeps them on chip with an online softmax over kv tiles in shared memory, and
reads q, k and v through their strides, so the projections' views go in
without fold/unfold copies. This first version runs both products as fp32 FMAs
on the CUDA cores; moving them to tensor cores (wgmma) is later work.

The forward returns no logsumexp: that output belongs with the backward
kernels (K2), which are not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda import CudaKernel
from .attention import FLASH_HEAD_DIMS, plain_attention

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_ptr = ctypes.c_void_p
_i64 = ctypes.c_longlong
KERNEL = CudaKernel(
    "flash_attention_fwd.cu",
    "flash_attention_fwd",
    [_ptr, _ptr, _ptr, _ptr, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64,
     ctypes.c_float, _ptr],
)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: the same math as ``plain_attention`` without
    mask or bias."""
    return plain_attention(q, k, v)


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [B,Sq,H,D]; k, v [B,Skv,H,D] -> [B,Sq,H,D] (contiguous).

    A CPU tensor goes to the plain version. A CUDA tensor launches the kernel
    or raises: bf16 or fp32, one dtype and one device for all three, unit
    stride over D."""
    _check(q, k, v)
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k, v on different devices: {devices}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or fp32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention needs unit stride over the head dim")
    b, sq, h, d = q.shape
    skv = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        KERNEL.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, sq, skv, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            d ** -0.5, stream,
        )
    return out
