"""Stage-level profiler for the single-device pipeline (run on the GPU).

Profiles the PRODUCTION path: device-resident sketching, then the fused
vote->suppress->compact dispatch feeding device-resident pairs to the
scorer (pipeline/overlapper._find_matches_device).  Stage attribution
inside the fused path comes from the overlapper's own timers
(minhash_search_time = vote dispatch + stats sync, sort_merge_time =
score dispatch + readback + formatting).
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench as B  # noqa: E402

from mhap_tpu.pipeline.overlapper import TpuOverlapper  # noqa: E402

reads = B.make_reads()
ov = TpuOverlapper(pair_chunk=2048)
ov.overlap_self(reads)  # warmup/compile
ov.overlap_self(reads)  # settling (escalation-ladder probing)

for trial in range(3):
    for k in ov.stats:
        ov.stats[k] = 0.0 if k.endswith("time") else 0
    ov.slow_pair_count = 0
    t0 = time.perf_counter()
    store = ov.sketch_reads(reads)
    t1 = time.perf_counter()
    index = ov._build_index(store)
    q_sel = np.nonzero(store.is_fwd)[0]
    lines = ov._find_matches(store, index, store, q_sel, True)
    t2 = time.perf_counter()
    lines = sorted(lines)
    t3 = time.perf_counter()
    print(f"trial{trial}: sketch {t1 - t0:.3f}s  find {t2 - t1:.3f}s "
          f"(vote+sync {ov.stats['minhash_search_time']:.3f}s, "
          f"score+fmt {ov.stats['sort_merge_time']:.3f}s)  "
          f"sort {t3 - t2:.3f}s  total {t3 - t0:.3f}s", flush=True)
    print(f"  rows {len(store)} pairs_scored "
          f"{ov.stats['sequences_fully_compared']} lines {len(lines)} "
          f"slow {ov.slow_pair_count}", flush=True)
