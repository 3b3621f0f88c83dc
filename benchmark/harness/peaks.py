"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit). Every roofline share and ``mfu`` is held to
the bf16 tensor-core rate whatever dtype computes the work, so a share reads
the same work whatever computes it, and none can pass 100%."""

PEAK_FLOPS = 989e12  # bf16 / fp16 tensor cores, FLOP/s
PEAK_BYTES = 3.35e12  # HBM3, bytes/s
