"""(K3 + K4 bound) / (K3 + K4 device time): csrc/texture_fetch.cu's
trilinear_sample_fwd, csrc/texture_scatter.cu's trilinear_sample_bwd and
its fold_top."""

from metrics._roofline import share


def read(rec):
    return share(rec, ("K3", "K4"),
                 ("trilinear_sample_fwd", "trilinear_sample_bwd", "fold_top"))
