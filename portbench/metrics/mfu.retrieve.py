"""mfu.retrieve: the encoder's forward FLOPs at the real (unpadded) token
counts of every encode of the measured window (matmuls and attention,
from the configuration's widths; the last layer at the CLS position
only), over the window's seconds times 989 TFLOP/s (H100 SXM dense bf16),
in percent."""

from portbench.harness import H100_BF16_FLOPS


def read(r):
    flops = r.extra.get("flops")
    if not flops or r.elapsed <= 0:
        return None
    return 100.0 * flops / (r.elapsed * H100_BF16_FLOPS)
