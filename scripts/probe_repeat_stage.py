"""Decompose the repeat regime's direct-fallback stage on the GPU.

Instruments (by wrapping, no pipeline changes) where the direct stage's
time goes: _score_wide wall inside the direct stage, the exact-automaton
rung (_rescore_slow), flagged-lane counts, host-oracle pair count, and
the format step.

Usage: python scripts/probe_repeat_stage.py [n_reads] > repeat_stage.json
"""

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


def main():
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 16_000
    genome_len = int(n_reads * 1550 / 25.0)
    n_copies = max(12, round(300 * n_reads / 40_000))
    genome = B.repeat_seeded_genome(genome_len, seed=B.SEED + 5,
                                    repeat_len=2000, n_copies=n_copies)
    reads, _, _ = B.make_reads_placed(n_reads, seed=B.SEED + 5,
                                      genome=genome,
                                      genome_len=genome_len)
    with tempfile.TemporaryDirectory() as td:
        fpath = os.path.join(td, "kmers.txt")
        B.write_filter_file(genome, 16, fpath)
        with open_text(fpath) as f:
            fc = FrequencyCounts(f, 1e-5, 0.9, 0, False, 3.0, True)
        ov = TpuOverlapper(kmer_filter=VectorFrequencyFilter(fc))
        if len(reads) * 2 < ov.WIDE_STORE_MIN:
            ov.WIDE_STORE_MIN = 10

        st = {"in_direct": False, "direct_s": 0.0, "score_direct_s": 0.0,
              "score_direct_calls": 0, "score_main_s": 0.0,
              "slow_s": 0.0, "slow_lanes": 0}

        orig_direct = ov._find_matches_direct
        orig_score = ov._score_wide
        orig_slow = ov._rescore_slow

        def w_direct(*a, **k):
            st["in_direct"] = True
            t0 = time.perf_counter()
            try:
                return orig_direct(*a, **k)
            finally:
                st["direct_s"] += time.perf_counter() - t0
                st["in_direct"] = False

        def w_score(*a, **k):
            t0 = time.perf_counter()
            try:
                return orig_score(*a, **k)
            finally:
                dt = time.perf_counter() - t0
                if st["in_direct"]:
                    st["score_direct_s"] += dt
                    st["score_direct_calls"] += 1
                else:
                    st["score_main_s"] += dt

        def w_slow(qs, cs, q_rows, c_rows):
            t0 = time.perf_counter()
            try:
                return orig_slow(qs, cs, q_rows, c_rows)
            finally:
                st["slow_s"] += time.perf_counter() - t0
                st["slow_lanes"] += len(q_rows)

        ov._find_matches_direct = w_direct
        ov._score_wide = w_score
        ov._rescore_slow = w_slow

        t0 = time.perf_counter()
        lines = ov.overlap_self(reads)
        warm = round(time.perf_counter() - t0, 1)
        print(f"[probe] warm {warm}s {len(lines)} overlaps",
              file=sys.stderr, flush=True)
        for k in st:
            if k != "in_direct":
                st[k] = 0
        sp0 = ov.slow_pair_count
        t0 = time.perf_counter()
        lines = ov.overlap_self(reads)
        total = round(time.perf_counter() - t0, 2)
        out = {"n_reads": n_reads, "warm_s": warm, "total_s": total,
               "overlaps": len(lines),
               "direct_stage_s": round(st["direct_s"], 2),
               "direct_score_s": round(st["score_direct_s"], 2),
               "direct_score_calls": st["score_direct_calls"],
               "main_score_s": round(st["score_main_s"], 2),
               "rescore_slow_s": round(st["slow_s"], 2),
               "rescore_slow_lanes": st["slow_lanes"],
               "host_oracle_pairs": ov.slow_pair_count - sp0}
        print(json.dumps({"repeat_stage_probe": out}))


if __name__ == "__main__":
    main()
