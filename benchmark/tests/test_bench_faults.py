"""A run with the timed path broken underneath comes out not correct: one
run for each fault a one-chip training cell can have (no exchange between
chips exists in it), and the exchange left out of the four-chip cell's
step. The harness's look for a card is skipped; the rest of a run is
driven on the CPU at a tiny size (four gloo processes for the four-chip
cell), with the cell's own limits."""

import time

import pytest

from conftest import tiny


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_fault_is_caught(fault):
    import harness
    from reference import check
    rec = harness.run("mono512.seq", 31337, 0.5, False, time.perf_counter(),
                      device="cpu", overrides=tiny("mono512.seq"),
                      fault=check.FAULTS[fault])
    assert not rec["correct"], rec["compared"]


def test_missing_exchange_is_caught():
    import harness
    rec = harness.run("nersemble16.seq.x4", 31337, 0.5, False, time.perf_counter(),
                      device="cpu", overrides=tiny("nersemble16.seq.x4"),
                      fault=harness.no_exchange)
    assert not rec["correct"], rec["compared"]
