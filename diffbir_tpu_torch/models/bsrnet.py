"""RRDBNet: the BSRNet x4 super-resolution cleaner (DiffBIR v2's blind SR).

Counterpart of ``diffbir_tpu/models/bsrnet.py`` (ESRGAN lineage): 23 RRDBs
of three 5-conv residual dense blocks, each scaled by 0.2 into its residual,
then two nearest + conv x2 upsamples. The image enters and leaves NHWC in
[0, 1] (the output is not clipped); convolutions run NCHW in the weights'
dtype, ``conv_last`` in fp32. Attribute names are the KAIR ``BSRNet.pth``
keys (``RRDB_trunk.0.RDB1.conv1``, ...), so the checkpoint loads strictly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import conv, nearest_upsample_2x


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class ResidualDenseBlock5C(nn.Module):
    def __init__(self, nf: int = 64, gc: int = 32, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = conv(nf, gc, 3, **kw)
        self.conv2 = conv(nf + gc, gc, 3, **kw)
        self.conv3 = conv(nf + 2 * gc, gc, 3, **kw)
        self.conv4 = conv(nf + 3 * gc, gc, 3, **kw)
        self.conv5 = conv(nf + 4 * gc, nf, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = _lrelu(self.conv1(x))
        x2 = _lrelu(self.conv2(torch.cat([x, x1], 1)))
        x3 = _lrelu(self.conv3(torch.cat([x, x1, x2], 1)))
        x4 = _lrelu(self.conv4(torch.cat([x, x1, x2, x3], 1)))
        x5 = self.conv5(torch.cat([x, x1, x2, x3, x4], 1))
        return x5 * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, nf: int = 64, gc: int = 32, dtype=torch.float32, device=None):
        super().__init__()
        self.RDB1 = ResidualDenseBlock5C(nf, gc, dtype, device)
        self.RDB2 = ResidualDenseBlock5C(nf, gc, dtype, device)
        self.RDB3 = ResidualDenseBlock5C(nf, gc, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.RDB3(self.RDB2(self.RDB1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """BSRNet: [0, 1] RGB NHWC in, x``sf`` NHWC fp32 out (``sf`` 4 or 2)."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64, nb: int = 23,
                 gc: int = 32, sf: int = 4, dtype=torch.float32, device=None):
        super().__init__()
        if sf not in (2, 4):
            raise ValueError(f"RRDBNet upsamples x2 or x4, not x{sf}")
        kw = dict(dtype=dtype, device=device)
        self.sf = sf
        self.dtype = dtype
        self.conv_first = conv(in_nc, nf, 3, **kw)
        self.RRDB_trunk = nn.Sequential(*(RRDB(nf, gc, dtype, device) for _ in range(nb)))
        self.trunk_conv = conv(nf, nf, 3, **kw)
        self.upconv1 = conv(nf, nf, 3, **kw)
        if sf == 4:
            self.upconv2 = conv(nf, nf, 3, **kw)
        self.HRconv = conv(nf, nf, 3, **kw)
        self.conv_last = conv(nf, out_nc, 3, dtype=torch.float32, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fea = self.conv_first(x.permute(0, 3, 1, 2).to(self.dtype))
        fea = fea + self.trunk_conv(self.RRDB_trunk(fea))
        fea = _lrelu(self.upconv1(nearest_upsample_2x(fea)))
        if self.sf == 4:
            fea = _lrelu(self.upconv2(nearest_upsample_2x(fea)))
        fea = _lrelu(self.HRconv(fea))
        return self.conv_last(fea.float()).permute(0, 2, 3, 1)
