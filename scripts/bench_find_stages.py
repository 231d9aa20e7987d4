"""Microbenchmark vote + scoring sub-stages on the GPU."""
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

import bench as B
from mhap_tpu.pipeline.overlapper import TpuOverlapper

reads = B.make_reads()
ov = TpuOverlapper(pair_chunk=2048)

t0 = time.perf_counter()
store = ov.sketch_reads(reads)
print(f"sketch_reads: {time.perf_counter()-t0:.2f}s", flush=True)

t0 = time.perf_counter()
postings = ov.build_postings(store)
print(f"build_postings(host): {time.perf_counter()-t0:.2f}s", flush=True)

q_sel = np.nonzero(store.is_fwd)[0]
t0 = time.perf_counter()
q_idx, cand, votes = ov.vote(postings, store.minhash[q_sel])
print(f"vote(host): {time.perf_counter()-t0:.2f}s  pairs={len(q_idx)}", flush=True)

# device postings + vote
from mhap_tpu.index.postings import build_postings_device, vote_device
t0 = time.perf_counter()
dev = build_postings_device(store.minhash)
jax.block_until_ready(dev)
print(f"build_postings(device): {time.perf_counter()-t0:.2f}s", flush=True)
qmh = store.minhash[q_sel]
import jax.numpy as jnp
qd = jnp.asarray(qmh)
t0 = time.perf_counter()
out = vote_device(dev[0], dev[1], qd, span_cap=32, top_k=256,
                  min_matches=3)
jax.block_until_ready(out)
print(f"vote(device, warm+compile): {time.perf_counter()-t0:.2f}s", flush=True)
t0 = time.perf_counter()
out = vote_device(dev[0], dev[1], qd, span_cap=32, top_k=256, min_matches=3)
jax.block_until_ready(out)
print(f"vote(device, steady): {time.perf_counter()-t0:.2f}s", flush=True)

# scoring: suppression + score_pairs with per-phase timers
cfg = ov.cfg
keepm = votes >= cfg["num_min_matches"]
qg = q_sel[q_idx]
c_hid = store.header_id[cand]; q_hid = store.header_id[qg]
keepm &= c_hid != q_hid
keepm &= ~((c_hid > q_hid))
qg, cand2 = qg[keepm], cand[keepm]
print(f"pairs to score: {len(qg)}", flush=True)

t0 = time.perf_counter()
score, raw, edges = ov.score_pairs(store, store, qg, cand2)
print(f"score_pairs total: {time.perf_counter()-t0:.2f}s "
      f"(slow={ov.slow_pair_count})", flush=True)

# isolate device scorer call
qq = qg[:2048].astype(np.int64); cc = cand2[:2048].astype(np.int64)
t0 = time.perf_counter()
o = ov._score_chunk(ov._score_fast, store, store, qq, cc)
jax.block_until_ready(o)
print(f"_score_chunk 2048 steady: {time.perf_counter()-t0:.2f}s", flush=True)
t0 = time.perf_counter()
o = {k: np.asarray(v) for k, v in o.items()}
print(f"readback: {time.perf_counter()-t0:.2f}s", flush=True)
