"""Weight-only int8 and packed-int4 matmuls: the quantisers, the CUDA kernels
(K4, K5), their plain versions, and the ``QuantLinear`` / ``Int4Linear``
layers.

Counterpart of ``diffbir_tpu/ops/quant_matmul.py``. K4 replaces its Pallas
TPU kernel ``_kernel`` (launched by ``_pallas_quant_matmul``) and is
``csrc/quant_matmul.cu``, with three entries: the tensor-core tile form
(``KERNEL_TC``) for M > 8 rows, the GEMV form (``KERNEL_GEMV``) for M <= 8,
both for bf16 and fp32 x (``quant_entries`` states the rule), and the first
CUDA-core version (``KERNEL``), which no path launches. K5 replaces
``_kernel_int4`` (launched by ``_pallas_quant_matmul_int4``) and is
``csrc/quant_matmul_int4.cu``, with the same three forms: the tensor-core
tile form (``KERNEL_INT4_TC``), the GEMV form (``KERNEL_INT4_GEMV``), both
for bf16 and fp32 x (``int4_entries`` states the rule), and the CUDA-core
version (``KERNEL_INT4``), which no path launches. Both sources are built
for ``sm_90a`` at first use.

int8: symmetric per output channel, w ~ w_q * scale[None, :]; the scale
commutes with the K sum, so it multiplies the fp32 accumulator once after it
(exact, not an approximation). Layout: w_q int8 [K, N] and scale fp32 [N].

int4: symmetric per (group of 128 rows of K, column) to [-7, 7], two values
per byte in the "window-halved" layout: within each 256-row window of K, the
low nibble of packed row r holds logical row r and the high nibble row
128 + r. Per-group scales do not commute with the K sum, so the weight is
dequantised (w_int * scale in fp32, rounded to bf16) before the product.
Layout: packed int8 [K/2, N] and scale_g fp32 [K/128, N].

Both layouts are the JAX package's, so one quantised tensor feeds both
packages. Every quantised site goes through its kernel: the JAX package's
alignment and M <= 1024 dispatch (XLA elsewhere) is not carried over, since
the math is the same.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ._cuda import CudaKernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("quant_matmul.cu", "quant_matmul",
                    [_ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _ptr])
KERNEL_TC = CudaKernel("quant_matmul.cu", "quant_matmul_tc",
                       [_ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _ptr])
KERNEL_GEMV = CudaKernel("quant_matmul.cu", "quant_matmul_gemv",
                         [_ptr, _ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _i32, _ptr])
GEMV_MAX_ROWS = 8  # the GEMV form's largest M
GEMV_MAX_SPLIT_ROWS = 2048  # rows of K per GEMV block (x's rows in shared memory)
KERNEL_INT4 = CudaKernel("quant_matmul_int4.cu", "quant_matmul_int4",
                         [_ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _ptr])
KERNEL_INT4_TC = CudaKernel("quant_matmul_int4.cu", "quant_matmul_int4_tc",
                            [_ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _ptr])
KERNEL_INT4_GEMV = CudaKernel("quant_matmul_int4.cu", "quant_matmul_int4_gemv",
                              [_ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _i32, _ptr])
INT4_GEMV_MAX_WINDOWS = 16  # windows of K per GEMV block (x's rows in shared memory)
INT4_GEMV_MAX_SPLITS = 8  # GEMV blocks per cluster (their sums are added in the cluster)
INT4_WINDOW = 256  # logical K rows per pack window
INT4_GROUP = 128  # K rows per scale group (the only group size K5 takes)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, N] float -> (int8 [K, N], fp32 scale [N]), symmetric per column:
    scale = max(absmax / 127, 1e-8), round half to even, clip to +-127 (the
    JAX ``quantize_weight``, bit for bit). The result is contiguous whatever
    w's strides (a transposed ``nn.Linear`` weight keeps them through
    ``.float()``, and a strided int8 tensor would be copied at every call)."""
    w = w.float().contiguous()
    scale = torch.clamp(w.abs().amax(dim=0) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale


def quant_matmul_ref(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: x [.., K] rounded to bf16, times the int8 weight
    [K, N], accumulated in fp32, times the fp32 scale [N] after the sum, cast
    to x's dtype (``_xla_quant_matmul``)."""
    acc = x.to(torch.bfloat16).float() @ w_q.float()
    return (acc * scale.float()).to(x.dtype)


def quant_entries(x: torch.Tensor) -> CudaKernel:
    """The K4 entry for x [.., K]: the GEMV form (``KERNEL_GEMV``) for at
    most ``GEMV_MAX_ROWS`` rows, else the tensor-core tile form
    (``KERNEL_TC``); both take bf16 and fp32 x."""
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    return KERNEL_GEMV if rows <= GEMV_MAX_ROWS else KERNEL_TC


@functools.lru_cache(maxsize=None)
def gemv_splits(m: int, n: int, k: int, sms: int) -> int:
    """Parts of K for the GEMV form: enough blocks (128 columns each) for ~4
    per SM, at least 256 rows a part, at most GEMV_MAX_SPLIT_ROWS."""
    col_blocks = -(-n // 128)
    splits = max(1, min(-(-4 * sms // col_blocks), -(-k // 256)))
    return max(splits, -(-k // GEMV_MAX_SPLIT_ROWS))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ready(t: torch.Tensor) -> bool:
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def _tc_operands(x2, w_q, scale):
    """The operands as the tensor-core entries take them: K a multiple of 8
    and N of 16 (else zero-padded: no path of the port needs it), every
    tensor contiguous and 16-byte aligned (else copied). Every site of the
    port's paths passes as it is."""
    k, n = w_q.shape
    if k % 8 == 0 and n % 16 == 0 and _ready(x2) and _ready(w_q) and _ready(scale):
        return x2, w_q, scale
    kp, np_ = -(-k // 8) * 8, -(-n // 16) * 16
    if (kp, np_) != (k, n):
        x2 = F.pad(x2, (0, kp - k))
        w_q = F.pad(w_q, (0, np_ - n, 0, kp - k))
        scale = F.pad(scale, (0, np_ - n), value=1.0)
    return [t if _ready(t) else t.clone(memory_format=torch.contiguous_format)
            for t in (x2, w_q, scale)]


def launch_quant(kernel: CudaKernel, x2: torch.Tensor, w_q: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """out [M, N] = x2 [M, K] @ dequant(w_q, scale) from one K4 entry on
    checked CUDA inputs (``quant_matmul`` picks the entry by
    ``quant_entries``)."""
    m, k = x2.shape
    n = w_q.shape[1]
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    code = _DTYPE_CODES[x2.dtype]
    if kernel is KERNEL:
        out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
        with torch.cuda.device(x2.device):
            KERNEL.launch(x2.contiguous().data_ptr(), w_q.contiguous().data_ptr(),
                          scale.contiguous().data_ptr(), out.data_ptr(), code, m, n, k, stream)
        return out
    x2, w_q, scale = _tc_operands(x2, w_q, scale)
    kp, np_ = w_q.shape
    out = torch.empty((m, np_), dtype=x2.dtype, device=x2.device)
    with torch.cuda.device(x2.device):
        if kernel is KERNEL_TC:
            KERNEL_TC.launch(x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                             code, m, np_, kp, stream)
        elif kernel is KERNEL_GEMV:
            splits = gemv_splits(m, np_, kp, _sm_count(x2.device.index))
            part = (torch.empty(splits * m * np_, dtype=torch.float32, device=x2.device)
                    if splits > 1 else None)
            KERNEL_GEMV.launch(x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                               None if part is None else part.data_ptr(), out.data_ptr(),
                               code, m, np_, kp, splits, stream)
        else:
            raise ValueError(f"not a K4 entry: {kernel.symbol}")
    return out if np_ == n else out[:, :n]


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [.., K] @ dequant(w_q [K, N], scale [N]) -> [.., N] in x's dtype.

    A CPU tensor goes to the plain version; a CUDA tensor launches the K4
    entry of ``quant_entries`` or raises (x bf16 or fp32, w_q int8, scale
    fp32, all on one device)."""
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
    x2 = x.reshape(-1, k)
    if x2.shape[0] == 0:
        return torch.empty((*lead, n), dtype=x.dtype, device=x.device)
    return launch_quant(quant_entries(x), x2, w_q, scale).reshape(*lead, n)


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


# --------------------------------------------------------------------------- #
# packed int4 (K5)
# --------------------------------------------------------------------------- #
def quantize_weight_int4(w: torch.Tensor, group_size: int = INT4_GROUP,
                         window: int = INT4_WINDOW) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, N] float -> (packed int8 [K/2, N], fp32 scale_g [K/group_size, N]):
    scale = max(absmax / 7, 1e-8) per group and column, round half to even,
    clip to +-7, window-halved packing (the JAX ``quantize_weight_int4`` and
    its numpy twin, bit for bit)."""
    k, n = w.shape
    if k % window or window % 2 or window % group_size:
        raise ValueError(f"int4 needs K % {window} == 0 and groups tiling a window; "
                         f"got K={k}, group {group_size}")
    w = w.float().contiguous()  # contiguous results, as quantize_weight
    scale = torch.clamp(w.reshape(k // group_size, group_size, n).abs().amax(dim=1) / 7.0,
                        min=1e-8)
    q = torch.clamp(torch.round(w / scale.repeat_interleave(group_size, dim=0)), -7, 7)
    qw = q.to(torch.int32).reshape(k // window, window, n)
    half = window // 2
    packed = ((qw[:, :half] & 0xF) | ((qw[:, half:] & 0xF) << 4)).to(torch.uint8)
    return packed.view(torch.int8).reshape(k // 2, n), scale


def unpack_int4(packed: torch.Tensor, window: int = INT4_WINDOW) -> torch.Tensor:
    """[K/2, N] packed int8 -> [K, N] int32 in [-7, 7]: each nibble sign
    extended, the low nibbles of a window's packed rows first, then its high
    nibbles."""
    kp, n = packed.shape
    p = packed.reshape(kp // (window // 2), window // 2, n).to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    return torch.cat([lo, hi], dim=1).reshape(kp * 2, n)


def quant_matmul_int4_ref(x: torch.Tensor, packed: torch.Tensor,
                          scale_g: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 (``_xla_quant_matmul_int4``): w_int * scale in
    fp32, rounded to bf16 before the product (per-group scales do not commute
    with the K sum); x rounded to bf16; fp32 sums; cast to x's dtype."""
    k = packed.shape[0] * 2
    groups = scale_g.shape[0]
    w = (unpack_int4(packed).reshape(groups, k // groups, -1).float()
         * scale_g.float()[:, None, :]).reshape(k, -1).to(torch.bfloat16)
    acc = x.to(torch.bfloat16).float() @ w.float()
    return acc.to(x.dtype)


def int4_entries(x: torch.Tensor) -> CudaKernel:
    """The K5 entry for x [.., K]: the GEMV form (``KERNEL_INT4_GEMV``) for
    at most ``GEMV_MAX_ROWS`` rows, else the tensor-core tile form
    (``KERNEL_INT4_TC``); both take bf16 and fp32 x."""
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    return KERNEL_INT4_GEMV if rows <= GEMV_MAX_ROWS else KERNEL_INT4_TC


@functools.lru_cache(maxsize=None)
def int4_gemv_splits(n: int, k: int, sms: int) -> int:
    """Parts of K (whole 256-row windows) for the int4 GEMV form: enough
    blocks (128 columns each) for ~2 per SM (on an H100 8 parts of 2
    windows ran faster at (1, 4096, 4096) than 4 or 16), at most
    INT4_GEMV_MAX_SPLITS parts of at most INT4_GEMV_MAX_WINDOWS windows;
    every part holds windows."""
    windows = k // INT4_WINDOW
    if windows > INT4_GEMV_MAX_SPLITS * INT4_GEMV_MAX_WINDOWS:
        raise ValueError(f"the int4 GEMV form takes K <= "
                         f"{INT4_GEMV_MAX_SPLITS * INT4_GEMV_MAX_WINDOWS * INT4_WINDOW}, got {k}")
    col_blocks = -(-n // 128)
    splits = min(max(1, -(-2 * sms // col_blocks)), windows, INT4_GEMV_MAX_SPLITS)
    splits = max(splits, -(-windows // INT4_GEMV_MAX_WINDOWS))
    return -(-windows // -(-windows // splits))


def launch_int4(kernel: CudaKernel, x2: torch.Tensor, packed: torch.Tensor,
                scale_g: torch.Tensor) -> torch.Tensor:
    """out [M, N] = x2 [M, K] @ dequant_int4(packed, scale_g) from one K5
    entry on checked CUDA inputs (``quant_matmul_int4`` picks the entry by
    ``int4_entries``). The new entries take N in whole 16-byte chunks (else
    packed and scale_g are zero- and one-padded: no path of the port needs
    it) and contiguous 16-byte aligned tensors (else copied)."""
    m, k = x2.shape
    n = packed.shape[1]
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    code = _DTYPE_CODES[x2.dtype]
    if kernel is KERNEL_INT4:
        out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
        with torch.cuda.device(x2.device):
            KERNEL_INT4.launch(x2.contiguous().data_ptr(), packed.contiguous().data_ptr(),
                               scale_g.contiguous().data_ptr(), out.data_ptr(), code, m, n, k,
                               stream)
        return out
    np_ = -(-n // 16) * 16
    if np_ != n:
        packed = F.pad(packed, (0, np_ - n))
        scale_g = F.pad(scale_g, (0, np_ - n), value=1.0)
    x2, packed, scale_g = [t if _ready(t) else t.clone(memory_format=torch.contiguous_format)
                           for t in (x2, packed, scale_g)]
    out = torch.empty((m, np_), dtype=x2.dtype, device=x2.device)
    with torch.cuda.device(x2.device):
        if kernel is KERNEL_INT4_TC:
            KERNEL_INT4_TC.launch(x2.data_ptr(), packed.data_ptr(), scale_g.data_ptr(),
                                  out.data_ptr(), code, m, np_, k, stream)
        elif kernel is KERNEL_INT4_GEMV:
            splits = int4_gemv_splits(np_, k, _sm_count(x2.device.index))
            KERNEL_INT4_GEMV.launch(x2.data_ptr(), packed.data_ptr(), scale_g.data_ptr(),
                                    out.data_ptr(), code, m, np_, k, splits, stream)
        else:
            raise ValueError(f"not a K5 entry: {kernel.symbol}")
    return out if np_ == n else out[:, :n]


def quant_matmul_int4(x: torch.Tensor, packed: torch.Tensor, scale_g: torch.Tensor) -> torch.Tensor:
    """x [.., K] @ dequant_int4(packed [K/2, N], scale_g [K/128, N]) -> [.., N]
    in x's dtype.

    A CPU tensor goes to the plain version; a CUDA tensor launches the K5
    entry of ``int4_entries`` or raises (x bf16 or fp32, packed int8,
    scale_g fp32 with one scale per 128 rows, K a whole number of 256-row
    windows, all on one device)."""
    kp, n = packed.shape
    k = 2 * kp
    if x.shape[-1] != k or scale_g.dim() != 2 or scale_g.shape[1] != n or k % INT4_WINDOW:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scale_g {tuple(scale_g.shape)} (K % {INT4_WINDOW} == 0 needed)")
    devices = {x.device, packed.device, scale_g.device}
    if len(devices) != 1:
        raise ValueError(f"quant_matmul_int4 tensors on different devices: {devices}")
    if x.device.type == "cpu":
        return quant_matmul_int4_ref(x, packed, scale_g)
    if x.device.type != "cuda":
        raise RuntimeError(f"quant_matmul_int4: no kernel for device {x.device}")
    if scale_g.shape[0] * INT4_GROUP != k:
        raise ValueError(f"K5 takes one scale per {INT4_GROUP} rows; got {scale_g.shape[0]} "
                         f"groups for K={k}")
    if x.dtype not in _DTYPE_CODES or packed.dtype != torch.int8 or scale_g.dtype != torch.float32:
        raise TypeError(f"quant_matmul_int4 takes bf16/fp32 x, int8 packed, fp32 scale_g; got "
                        f"{x.dtype}, {packed.dtype}, {scale_g.dtype}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if x2.shape[0] == 0:
        return torch.empty((*lead, n), dtype=x.dtype, device=x.device)
    return launch_int4(int4_entries(x), x2, packed, scale_g).reshape(*lead, n)


class Int4Linear(nn.Module):
    """Weight-only packed-int4 linear (the LLaVA captioner's 4-bit mode):
    y = quant_matmul_int4(x, weight_q4, weight_scale_g) (+ bias). Buffers
    ``weight_q4`` int8 [in/2, out] and ``weight_scale_g`` fp32 [in/128, out]
    in the JAX layout; x is cast to the compute ``dtype`` first."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if in_dim % INT4_WINDOW:
            raise ValueError(f"Int4Linear needs in_dim % {INT4_WINDOW} == 0, got {in_dim}")
        self.dtype = dtype
        self.register_buffer("weight_q4", torch.zeros(in_dim // 2, out_dim, dtype=torch.int8,
                                                      device=device))
        self.register_buffer("weight_scale_g", torch.ones(in_dim // INT4_GROUP, out_dim,
                                                          device=device))
        self.bias = (nn.Parameter(torch.zeros(out_dim, dtype=dtype, device=device),
                                  requires_grad=False) if bias else None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, linear: nn.Linear) -> "Int4Linear":
        """Quantise a float ``nn.Linear`` (weight [out, in]) from its current
        values."""
        out_dim, in_dim = linear.weight.shape
        q = cls(in_dim, out_dim, bias=linear.bias is not None, dtype=linear.weight.dtype,
                device=linear.weight.device)
        q.weight_q4, q.weight_scale_g = quantize_weight_int4(linear.weight.T)
        if linear.bias is not None:
            q.bias.copy_(linear.bias)
        return q

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = quant_matmul_int4(x.to(self.dtype), self.weight_q4, self.weight_scale_g)
        return y if self.bias is None else y + self.bias.to(y.dtype)
