"""Median host time to produce one batch from the tracker's `_batches`
(each next() of the stream the loop is fed, on its prefetch thread)."""

import statistics


def read(rec):
    times = rec.get("host_batch_s")
    return 1e3 * statistics.median(times) if times else None
