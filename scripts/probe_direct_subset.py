"""GPU A/B probe of the family-subset direct vote.

Times the repeat40k recipe at a reduced read count, runs the direct
stage with the subset restriction OFF then ON in one process, and
asserts line-set sha256 equality between the two -- an at-scale
exactness witness on real data on top of the CPU differential tests
(tests/test_joinvote.py).

Usage: python scripts/probe_direct_subset.py [n_reads] > direct_subset.json
"""

import hashlib
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import bench as B  # noqa: E402
from mhap_tpu.io.fasta import open_text  # noqa: E402
from mhap_tpu.oracle.filter import FrequencyCounts  # noqa: E402
from mhap_tpu.pipeline.freqfilter import VectorFrequencyFilter  # noqa: E402
from mhap_tpu.pipeline.overlapper import TpuOverlapper  # noqa: E402


def lineset_sha(lines):
    h = hashlib.sha256()
    for ln in sorted(lines):
        h.update(ln.encode())
        h.update(b"\n")
    return h.hexdigest()


def main():
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 16_000
    # repeat40k recipe scaled: same coverage, same 2kb family, copy
    # count proportional to genome length (bench_config_repeat40k)
    genome_len = int(n_reads * 1550 / 25.0)
    n_copies = max(12, round(300 * n_reads / 40_000))
    genome = B.repeat_seeded_genome(genome_len, seed=B.SEED + 5,
                                    repeat_len=2000, n_copies=n_copies)
    reads, _, _ = B.make_reads_placed(n_reads, seed=B.SEED + 5,
                                      genome=genome,
                                      genome_len=genome_len)
    with tempfile.TemporaryDirectory() as td:
        fpath = os.path.join(td, "kmers.txt")
        n_rows = B.write_filter_file(genome, 16, fpath)
        with open_text(fpath) as f:
            fc = FrequencyCounts(f, 1e-5, 0.9, 0, False, 3.0, True)
        vf = VectorFrequencyFilter(fc)
        ov = TpuOverlapper(kmer_filter=vf)
        if len(reads) * 2 < ov.WIDE_STORE_MIN:
            ov.WIDE_STORE_MIN = 10  # keep the real wide path at probe size

        probe = {"n": 0, "direct_s": 0.0, "q_fb": 0}
        orig = ov._find_matches_direct

        def timed(queries, store, q_rows, to_self):
            t0 = time.perf_counter()
            out = orig(queries, store, q_rows, to_self)
            probe["direct_s"] += time.perf_counter() - t0
            probe["n"] += 1
            probe["q_fb"] += len(q_rows)
            return out

        ov._find_matches_direct = timed

        def runs(tag, k=2):
            times, dts = [], []
            lines = None
            for _ in range(k):
                probe["direct_s"] = 0.0
                probe["q_fb"] = 0
                t0 = time.perf_counter()
                lines = ov.overlap_self(reads)
                times.append(round(time.perf_counter() - t0, 2))
                dts.append(round(probe["direct_s"], 2))
                print(f"[probe] {tag}: total {times[-1]}s "
                      f"direct {dts[-1]}s q_fb {probe['q_fb']}",
                      file=sys.stderr, flush=True)
            return times, dts, lines

        t0 = time.perf_counter()
        ov.direct_subset = False
        lines = ov.overlap_self(reads)
        warm = round(time.perf_counter() - t0, 1)
        print(f"[probe] warm {warm}s, {len(lines)} overlaps",
              file=sys.stderr, flush=True)
        off_t, off_d, off_lines = runs("subset-off")
        ov.direct_subset = True
        ov.overlap_self(reads)  # settle (subset-path compiles)
        on_t, on_d, on_lines = runs("subset-on")

        out = {"n_reads": n_reads, "n_copies": n_copies,
               "filter_kmers": n_rows, "warm_s": warm,
               "overlaps": len(on_lines),
               "q_fallback": probe["q_fb"],
               "subset_rows": ov.stats.get("direct_subset_rows"),
               "store_rows": 2 * len(reads),
               "total_off_s": off_t, "direct_off_s": off_d,
               "total_on_s": on_t, "direct_on_s": on_d,
               "lineset_sha256_match":
                   lineset_sha(off_lines) == lineset_sha(on_lines),
               "overlaps_match": len(off_lines) == len(on_lines)}
        print(json.dumps({"direct_subset_probe": out}))


if __name__ == "__main__":
    main()
