"""mfu.read: the reader's forward FLOPs at the real (unpadded) token
counts of every chain read in the measured window (matmuls, attention and
heads, from the configuration's widths), over the window's seconds times
989 TFLOP/s (H100 SXM dense bf16), in percent."""

from portbench.harness import H100_BF16_FLOPS


def read(r):
    flops = r.extra.get("flops")
    if not flops or r.elapsed <= 0:
        return None
    return 100.0 * flops / (r.elapsed * H100_BF16_FLOPS)
