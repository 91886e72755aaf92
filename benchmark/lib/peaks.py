"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its full
700 W power limit). Every roofline and ``mfu`` share is stated against
these, with the card's power limit beside it in PERF.md."""

BF16_FLOPS = 989e12      # FLOP/s, bf16 and fp16 on the tensor cores
HBM_BYTES = 3.35e12      # bytes/s
