"""Device-resident tf-idf/legacy filtered sketching.

The filtered sketch flow must produce BIT-IDENTICAL sketch stores to the
host float64 weighting flow (_sketch_entries_host), across weight modes,
the cap-escalation ladder, and the count-beyond-LUT (W_SENT) host escape
hatch.  Reference weight semantics: sketch/MinHashSketch.java:95-128 +
sketch/FrequencyCounts.java:290-311.
"""

import numpy as np
import pytest

from mhap_tpu.oracle.filter import FrequencyCounts
from mhap_tpu.pipeline.freqfilter import VectorFrequencyFilter
from mhap_tpu.pipeline.overlapper import TpuOverlapper

from test_filter import CFG, make_fc, make_filter_file


def _stores_equal(a, b):
    np.testing.assert_array_equal(a.header_id, b.header_id)
    np.testing.assert_array_equal(a.is_fwd, b.is_fwd)
    np.testing.assert_array_equal(a.minhash, b.minhash)
    np.testing.assert_array_equal(a.ordered_h, b.ordered_h)
    np.testing.assert_array_equal(a.ordered_p, b.ordered_p)
    np.testing.assert_array_equal(a.ordered_m, b.ordered_m)


def _device_and_host_stores(reads, fc, rw):
    cfg = dict(CFG, repeat_weight=rw)
    dev = TpuOverlapper(cfg, kmer_filter=VectorFrequencyFilter(fc))
    host = TpuOverlapper(cfg, kmer_filter=VectorFrequencyFilter(fc))
    host.FILTER_DEVICE = False  # instance override -> host flow
    return dev, host


@pytest.mark.parametrize("rw,no_tf", [
    (0.9, False),   # default tf-idf (counts matter)
    (0.9, True),    # no-tf (count-independent weights)
    (-1.0, False),  # legacy popularity weights
])
def test_device_filtered_store_bit_equal(synthetic_reads, rw, no_tf):
    _, reads, _ = synthetic_reads
    reads = reads[:8]
    lines = make_filter_file(reads)
    fc = make_fc(lines, rw, 0, no_tf)
    dev, host = _device_and_host_stores(reads, fc, rw)
    assert dev._filter_device() is not None  # routing sanity
    assert host._filter_device() is None
    _stores_equal(dev.sketch_reads(reads), host.sketch_reads(reads))


def test_device_filtered_routing_modes(synthetic_reads):
    """remove_unique 1/2 stay on the host flow; tf mode >= 1.0 runs the
    plain kernel (weight == count)."""
    _, reads, _ = synthetic_reads
    lines = make_filter_file(reads[:6])
    for ru in (1, 2):
        fc = make_fc(lines, 0.9, ru)
        ov = TpuOverlapper(dict(CFG), kmer_filter=VectorFrequencyFilter(fc))
        assert ov._filter_device() is None
    fc = make_fc(lines, 1.5, 0)
    ov = TpuOverlapper(dict(CFG, repeat_weight=1.5),
                       kmer_filter=VectorFrequencyFilter(fc))
    assert ov._filter_device() is None  # plain kernel, no tables


def test_device_filtered_cap_escalation(synthetic_reads):
    """A read with a >5x tandem k-mer gets weight > 16 (= 3 x count at
    the default idf scale), exceeding the filtered base rung: the device
    cap ladder must re-sketch it exactly."""
    _, reads, _ = synthetic_reads
    reads = list(reads[:6])
    # 8 tandem copies of a 20-mer: inner 16-mers repeat 8 times -> w ~ 24
    tandem = "ACGTACGGTCAGTCATGCAT" * 8
    reads.append(reads[0][:800] + tandem + reads[1][:800])
    lines = make_filter_file(reads)
    fc = make_fc(lines, 0.9, 0, False)
    dev, host = _device_and_host_stores(reads, fc, 0.9)
    dev_store = dev.sketch_reads(reads)
    _stores_equal(dev_store, host.sketch_reads(reads))


def test_device_filtered_count_beyond_lut(synthetic_reads):
    """Counts beyond the weight LUT's CMAX flag W_SENT and re-sketch via
    the exact host float64 path."""
    _, reads, _ = synthetic_reads
    reads = list(reads[:5])
    tandem = "ACGTACGGTCAGTCATGCAT" * 8
    reads.append(reads[0][:800] + tandem + reads[1][:800])
    lines = make_filter_file(reads)
    fc = make_fc(lines, 0.9, 0, False)
    cfg = dict(CFG, repeat_weight=0.9)
    dev = TpuOverlapper(cfg, kmer_filter=VectorFrequencyFilter(fc))
    # shrink the LUT so the tandem k-mers (count 8) overflow it
    t = dev.kmer_filter.device_tables(0.9, cmax=4)
    import jax.numpy as jnp

    dev._filt_dev = ((jnp.asarray(t["t_hi"]), jnp.asarray(t["t_lo"]),
                      jnp.asarray(t["wlut"])),
                     (t["W"], t["cmax"], t["counts_matter"]))
    called = {"host": 0}
    orig = dev._sketch_rows_host_filt

    def spy(codes_list):
        called["host"] += 1
        return orig(codes_list)

    dev._sketch_rows_host_filt = spy
    host = TpuOverlapper(cfg, kmer_filter=VectorFrequencyFilter(fc))
    host.FILTER_DEVICE = False
    _stores_equal(dev.sketch_reads(reads), host.sketch_reads(reads))
    assert called["host"] > 0


def test_device_filtered_end_to_end_lines(synthetic_reads):
    """Full overlap run parity: device filtered flow vs host flow."""
    _, reads, _ = synthetic_reads
    reads = reads[:10]
    lines = make_filter_file(reads)
    fc = make_fc(lines, 0.9, 0, False)
    dev, host = _device_and_host_stores(reads, fc, 0.9)
    assert dev.overlap_self(reads) == host.overlap_self(reads)
