"""Fused GEGLU feed-forward: the CUDA kernel (K7), its plain version, and the
autograd Function around it.

Counterpart of ``diffbir_tpu/ops/fused_ffn.py``: K7 replaces its Pallas TPU
kernel ``_kernel`` (launched by ``_fused_ffn_impl``) and is
``csrc/fused_ffn.cu``, built for ``sm_90a`` at first use, with two entries
(``ffn_entries`` states the rule): the tensor-core design (``KERNEL_TC``)
for bf16, the CUDA-core one (``KERNEL``) for fp32, whose products the bf16
tensor cores do not give.
out = (a * gelu_erf(g)) @ W2^T + b2 with [a, g] = x @ W1^T + b1, in the
kernel's rounding points: h in fp32, the exact-erf GELU in fp32, act rounded
to x's dtype before the second product, fp32 accumulation and bias, one cast.
Unlike the JAX ``supported()``, every width goes through K7, d = 320 too.

Weights are in PyTorch's Linear layout, as the module holds them: w1
[2 inner, d] (rows [0, inner) the value half, the rest the gate), b1
[2 inner], w2 [d, inner], b2 [d]. On the H100 the act [N, inner] tensor
makes one round trip through device memory, which the TPU kernel kept in
VMEM (see the source's note).

Differentiable as in JAX (its custom VJP, which has no backward kernel): the
backward recomputes the plain version under autograd.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda import CudaKernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("fused_ffn.cu", "fused_ffn", [_ptr] * 7 + [_i32] * 4 + [_ptr])
KERNEL_TC = CudaKernel("fused_ffn.cu", "fused_ffn_tc", [_ptr] * 7 + [_i32] * 4 + [_ptr])


def fused_ffn_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                  b2: torch.Tensor) -> torch.Tensor:
    """Plain version of K7, x [N, d] -> [N, d] in x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    w1, b1, w2, b2 = (t.to(x.dtype).to(acc) for t in (w1, b1, w2, b2))
    h = x.to(acc) @ w1.T + b1
    a, g = h.chunk(2, dim=-1)
    act = a * (0.5 * g * (1.0 + torch.erf(g * 2.0 ** -0.5)))
    out = act.to(x.dtype).to(acc) @ w2.T + b2
    return out.to(x.dtype)


def ffn_entries(x: torch.Tensor) -> CudaKernel:
    """The K7 entry for x [N, d]: the tensor-core design (``KERNEL_TC``) for
    bf16 with d a multiple of 8, the CUDA-core one (``KERNEL``) for fp32 and
    any other width."""
    return KERNEL_TC if x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0 else KERNEL


def launch_ffn(kernel: CudaKernel, x, w1, b1, w2, b2) -> torch.Tensor:
    """out [N, d] from one K7 entry (``fused_ffn`` picks it by
    ``ffn_entries``). The tensor-core entry takes bf16 only; a tensor that
    is not contiguous and 16-byte aligned is copied first."""
    n, d = x.shape
    inner = w2.shape[1]
    for t in (x, w1, w2):
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError("fused_ffn: x, w1 and w2 need one CUDA device and dtype")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_ffn takes bf16 or fp32, got {x.dtype}")
    if kernel is KERNEL_TC and x.dtype != torch.bfloat16:
        raise TypeError(f"the tensor-core K7 takes bf16, got {x.dtype}")
    b1, b2 = (b.to(x.device, x.dtype) for b in (b1, b2))
    args = [t if t.is_contiguous() and t.data_ptr() % 16 == 0
            else t.clone(memory_format=torch.contiguous_format) for t in (x, w1, b1, w2, b2)]
    act = torch.empty((n, inner), dtype=x.dtype, device=x.device)
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    ptrs = [t.data_ptr() for t in args] + [act.data_ptr(), out.data_ptr()]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if kernel is KERNEL_TC:
            KERNEL_TC.launch(*ptrs, _DTYPE_CODES[x.dtype], n, d, inner, stream)
        elif kernel is KERNEL:
            KERNEL.launch(*ptrs, _DTYPE_CODES[x.dtype], n, d, inner, stream)
        else:
            raise ValueError(f"not a K7 entry: {kernel.symbol}")
    return out


class FusedFFN(torch.autograd.Function):
    """K7 forward; the backward differentiates the recomputed plain version
    (the JAX custom VJP's recompute, ``_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return launch_ffn(ffn_entries(x), x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = fused_ffn_ref(*inputs)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """x [N, d] -> [N, d], differentiable. A CPU tensor goes to the plain
    version; a CUDA tensor launches the K7 entry of ``ffn_entries`` or
    raises (bf16 or fp32; the weights in x's dtype). Weights and biases
    enter in x's dtype, as the JAX kernel casts its weights (its serving
    biases are in that dtype too)."""
    if x.dim() != 2 or w1.shape != (2 * w2.shape[1], x.shape[1]) or w2.shape[0] != x.shape[1]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                         f"w2 {tuple(w2.shape)}")
    if x.device.type == "cpu":
        return fused_ffn_ref(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_ffn: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        return FusedFFN.apply(x, w1, b1, w2, b2)
    return launch_ffn(ffn_entries(x), x, w1, b1, w2, b2)
