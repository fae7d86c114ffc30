"""(K2f + K2b bound) / (K2f + K2b device time): csrc/interp.cu's
fused_interp_fwd and csrc/interp_bwd.cu's fused_interp_bwd_tiles."""

from metrics._roofline import share


def read(rec):
    return share(rec, ("K2f", "K2b"), ("fused_interp_fwd", "fused_interp_bwd"))
