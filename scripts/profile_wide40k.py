"""Fine-grained stage profile of the wide-store 40k path (run on the GPU)."""
import sys, time
import numpy as np
sys.path.insert(0, __file__.rsplit("/", 2)[0])
import jax
import bench as B
from mhap_tpu.pipeline.overlapper import TpuOverlapper
from mhap_tpu.index import joinvote as JV

reads, _, _ = B.make_reads_placed(40_000, seed=B.SEED + 3)
ov = TpuOverlapper()
t0 = time.perf_counter()
lines = ov.overlap_self(reads)
print(f"warm: {time.perf_counter()-t0:.1f}s lines={len(lines)}", flush=True)
for r in range(2):
    t0 = time.perf_counter(); ov.overlap_self(reads)
    print(f"settle{r}: {time.perf_counter()-t0:.1f}s", flush=True)

for trial in range(2):
    T0 = time.perf_counter()
    t0 = time.perf_counter()
    store = ov.sketch_reads(reads, defer_flags=ov._defer_flags)
    t_sketch = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = ov._build_index(store)
    index[1][0].block_until_ready()
    t_index = time.perf_counter() - t0
    q_sel = np.nonzero(store.is_fwd)[0].astype(np.int32)
    t0 = time.perf_counter()
    ji = JV.JoinedIndex(index[1][0], index[1][1], store.dev("minhash"), q_sel)
    t_stageA = time.perf_counter() - t0
    t0 = time.perf_counter()
    span, fb = ji.plan_span()
    cand = ji.build_candidates(span)
    cand.block_until_ready()
    t_stageB = time.perf_counter() - t0
    t0 = time.perf_counter()
    cand, over = ji.apply_residuals(cand, span)
    cand.block_until_ready()
    t_resid = time.perf_counter() - t0
    # stage C + score via the driver (reuse internals)
    for k in ov.stats:
        ov.stats[k] = 0.0 if k.endswith("time") else 0
    ov.slow_pair_count = 0
    t0 = time.perf_counter()
    lines = ov._find_matches_wide(index, store, np.nonzero(store.is_fwd)[0], True)
    t_find = time.perf_counter() - t0
    t0 = time.perf_counter()
    lines = sorted(lines)
    t_sort = time.perf_counter() - t0
    print(f"trial{trial}: pairs={ov.stats['sequences_fully_compared']} "
          f"slow={ov.slow_pair_count} "
          f"matches={ov.stats['matches_processed']}")
    print(f"trial{trial}: sketch {t_sketch:.2f} index {t_index:.2f} "
          f"A {t_stageA:.2f} B({span}) {t_stageB:.2f} resid {t_resid:.2f} "
          f"find(C+D) {t_find:.2f} (vote {ov.stats['minhash_search_time']:.2f} "
          f"score {ov.stats['sort_merge_time']:.2f}) sort {t_sort:.2f} "
          f"TOTAL(with dup A/B) {time.perf_counter()-T0:.2f} lines {len(lines)}",
          flush=True)
