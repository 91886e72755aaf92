"""int8 weight-only matmul: the quantiser, the CUDA kernel (K4), its plain
version, and the ``QuantLinear`` serving layer.

Counterpart of the int8 half of ``diffbir_tpu/ops/quant_matmul.py``: K4
replaces its Pallas TPU kernel ``_kernel`` (launched by
``_pallas_quant_matmul``), and is ``csrc/quant_matmul.cu``, built for
``sm_90a`` at first use. Quantisation is symmetric per output channel,
w ~ w_q * scale[None, :]; the scale commutes with the K sum, so it multiplies
the fp32 accumulator once after it (exact, not an approximation).

Layout: w_q int8 [K, N] and scale fp32 [N], the JAX package's layout, so one
quantised tensor feeds both packages. Every quantised site goes through K4:
the JAX package's 128-alignment dispatch (XLA below it) is not carried over,
since the math is the same.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch import nn

from ._cuda import CudaKernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("quant_matmul.cu", "quant_matmul",
                    [_ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _ptr])


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, N] float -> (int8 [K, N], fp32 scale [N]), symmetric per column:
    scale = max(absmax / 127, 1e-8), round half to even, clip to +-127 (the
    JAX ``quantize_weight``, bit for bit)."""
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=0) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale


def quant_matmul_ref(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: x [.., K] rounded to bf16, times the int8 weight
    [K, N], accumulated in fp32, times the fp32 scale [N] after the sum, cast
    to x's dtype (``_xla_quant_matmul``)."""
    acc = x.to(torch.bfloat16).float() @ w_q.float()
    return (acc * scale.float()).to(x.dtype)


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [.., K] @ dequant(w_q [K, N], scale [N]) -> [.., N] in x's dtype.

    A CPU tensor goes to the plain version; a CUDA tensor launches K4 or
    raises (x bf16 or fp32, w_q int8, scale fp32, all on one device)."""
    k, n = w_q.shape
    if x.shape[-1] != k or scale.shape != (n,):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w_q {tuple(w_q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    devices = {x.device, w_q.device, scale.device}
    if len(devices) != 1:
        raise ValueError(f"quant_matmul tensors on different devices: {devices}")
    if x.device.type == "cpu":
        return quant_matmul_ref(x, w_q, scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"quant_matmul: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES or w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"quant_matmul takes bf16/fp32 x, int8 w_q, fp32 scale; got "
                        f"{x.dtype}, {w_q.dtype}, {scale.dtype}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m:
        with torch.cuda.device(x.device):
            KERNEL.launch(x2.data_ptr(), w_q.contiguous().data_ptr(),
                          scale.contiguous().data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype],
                          m, n, k, torch.cuda.current_stream(x.device).cuda_stream)
    return out.reshape(*lead, n)


class QuantLinear(nn.Module):
    """Weight-only int8 linear for the serving mode: y = quant_matmul(x,
    weight_q, weight_scale) (+ bias, added in the activation dtype, as the
    JAX ``QuantDense`` does). ``weight_q`` int8 [in, out] and
    ``weight_scale`` fp32 [out] are buffers (never trained); x is cast to the
    compute ``dtype`` first, as the float layers cast to their weights'."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("weight_q", torch.zeros(in_dim, out_dim, dtype=torch.int8,
                                                     device=device))
        self.register_buffer("weight_scale", torch.ones(out_dim, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_dim, dtype=dtype, device=device),
                                  requires_grad=False) if bias else None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, linear: nn.Linear) -> "QuantLinear":
        """Quantise a float ``nn.Linear`` (weight [out, in]) from its current
        values."""
        out_dim, in_dim = linear.weight.shape
        q = cls(in_dim, out_dim, bias=linear.bias is not None, dtype=linear.weight.dtype,
                device=linear.weight.device)
        q.weight_q, q.weight_scale = quantize_weight(linear.weight.T)
        if linear.bias is not None:
            q.bias.copy_(linear.bias)
        return q

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = quant_matmul(x.to(self.dtype), self.weight_q, self.weight_scale)
        return y if self.bias is None else y + self.bias.to(y.dtype)
