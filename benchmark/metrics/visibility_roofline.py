"""K1's share of its roofline: csrc/visibility.cu's bin_faces and
raster_tiles."""

from metrics._roofline import share


def read(rec):
    return share(rec, ("K1",), ("bin_faces", "raster_tiles"))
