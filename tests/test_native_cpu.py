"""Differential test: the native C++ pipeline (written from the Java
reference sources, independent of the Python oracle) must produce the
identical M4 line set.  Agreement of two independently derived
implementations is the strongest available substitute for jar goldens
(no JVM is available to the tests).
"""

import os
import subprocess

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(REPO, "native", "build", "mhap_cpu")


def _ensure_binary():
    from mhap_tpu.utils.native import build

    build()
    return BIN


def _run_cpp(reads, extra=()):
    import tempfile

    _ensure_binary()
    with tempfile.NamedTemporaryFile("w", suffix=".fa", delete=False) as f:
        for i, r in enumerate(reads):
            f.write(f">read{i}\n{r}\n")
        path = f.name
    try:
        out = subprocess.run(
            [BIN, "-s", path, "--num-threads", "2", *extra],
            capture_output=True, text=True, check=True)
    finally:
        os.unlink(path)
    return sorted(out.stdout.strip().splitlines())


def _noisy_reads(n, seed, genome_len=12000, read_len=1500, err=0.12):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.integers(0, 4, genome_len)
    reads = []
    for _ in range(n):
        pos = int(rng.integers(0, genome_len - read_len - 1))
        raw = genome[pos:pos + int(read_len * 1.1)]
        out = []
        for b in raw:
            r = rng.random()
            if r < err * 0.4:
                out.extend([b, int(rng.integers(0, 4))])
            elif r < err * 0.7:
                pass
            elif r < err:
                out.append(int(rng.integers(0, 4)))
            else:
                out.append(b)
            if len(out) >= read_len:
                break
        reads.append(bytes(bases[np.asarray(out[:read_len])]).decode())
    return reads


def test_cpp_matches_oracle_default_settings():
    from mhap_tpu.oracle.pipeline import overlap_self

    reads = _noisy_reads(24, seed=7)
    assert _run_cpp(reads) == sorted(overlap_self(reads))


def test_cpp_matches_oracle_fast_preset():
    """--settings 2 equivalent flags (MhapMain.java:158-177)."""
    from mhap_tpu.oracle.pipeline import overlap_self

    reads = _noisy_reads(16, seed=11, err=0.08)
    cfg = dict(num_hashes=256, threshold=0.80, ordered_sketch_size=1000,
               ordered_kmer_size=14)
    cpp = _run_cpp(reads, extra=[
        "--num-hashes", "256", "--threshold", "0.80",
        "--ordered-sketch-size", "1000", "--ordered-kmer-size", "14"])
    assert cpp == sorted(overlap_self(reads, cfg=cfg))


def test_cpp_matches_oracle_legacy_weight_and_min_store():
    from mhap_tpu.oracle.pipeline import overlap_self

    reads = _noisy_reads(16, seed=13)
    cpp = _run_cpp(reads, extra=["--repeat-weight", "-1",
                                 "--min-store-length", "1200"])
    assert cpp == sorted(overlap_self(reads, cfg=dict(
        repeat_weight=-1.0, min_store_length=1200)))


def test_cpp_matches_oracle_with_filter_file(tmp_path):
    """tf-idf filter-file path: C++ -f == oracle FrequencyCounts
    (sketch/FrequencyCounts.java:100-186,290-311 weighting)."""
    from collections import Counter

    from mhap_tpu.oracle.filter import FrequencyCounts
    from mhap_tpu.oracle.pipeline import overlap_self

    rng = np.random.default_rng(23)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.integers(0, 4, 12000)
    repeat = rng.integers(0, 4, 600)
    for _ in range(6):
        pos = int(rng.integers(0, 12000 - 600))
        genome[pos:pos + 600] = repeat
    gs = bytes(bases[genome]).decode()
    k = 16
    total = len(gs) - k + 1
    counts = Counter(gs[i:i + k] for i in range(total))
    fpath = tmp_path / "kmers.txt"
    rows = [(km, c / total) for km, c in counts.most_common(800)
            if c / total >= 1e-5]
    with open(fpath, "w") as f:
        f.write(f"{len(rows)} {len(rows)}\n")
        for km, frac in rows:
            f.write(f"{km} {frac:.10g}\n")

    reads = []
    for _ in range(20):
        pos = int(rng.integers(0, 12000 - 1600))
        raw = genome[pos:pos + 1650]
        out = []
        for b in raw:
            r = rng.random()
            if r < 0.05:
                out.extend([b, int(rng.integers(0, 4))])
            elif r < 0.08:
                pass
            else:
                out.append(b)
            if len(out) >= 1500:
                break
        reads.append(bytes(bases[np.asarray(out[:1500])]).decode())

    with open(fpath) as f:
        fc = FrequencyCounts(f, 1e-5, 0.9, 0, False, 3.0, True)
    want = sorted(overlap_self(reads, kmer_filter=fc))
    got = _run_cpp(reads, extra=["-f", str(fpath)])
    assert got == want
    # the filter must actually change the outcome on this input, or the
    # test proves nothing
    assert got != _run_cpp(reads)


def test_cpp_matches_device_pipeline():
    """Close the triangle: C++ == device (oracle == device is tested
    elsewhere; this pins all three on one input)."""
    from mhap_tpu.pipeline.overlapper import TpuOverlapper

    reads = _noisy_reads(16, seed=17)
    dev = sorted(TpuOverlapper().overlap_self(reads))
    assert _run_cpp(reads) == dev
