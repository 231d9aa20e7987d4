"""Single-device vs D=1-sharded backend comparison on the GPU
(quantifies the sharded path's overhead -- two all_to_alls +
psum-gather scoring -- on hardware, even without several cards).

Emits ONE JSON line:
  {"device_reads_per_s", "sharded_d1_reads_per_s", "overhead_x",
   "lines_equal", ...}
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

import bench as B  # noqa: E402
from mhap_tpu.parallel.sharded import ShardedOverlapper, make_mesh  # noqa: E402
from mhap_tpu.pipeline.overlapper import TpuOverlapper  # noqa: E402


def steady(ov, reads, settles=2, reps=3):
    lines = ov.overlap_self(reads)
    for _ in range(settles):
        ov.overlap_self(reads)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        lines = ov.overlap_self(reads)
        times.append(time.perf_counter() - t0)
    return sorted(times)[reps // 2], sorted(lines)


def run_config(name, reads, settles=2, reps=3):
    dev_t, dev_lines = steady(TpuOverlapper(pair_chunk=2048), reads,
                              settles, reps)
    mesh = make_mesh(jax.devices()[:1])
    sh_t, sh_lines = steady(ShardedOverlapper(mesh), reads, settles, reps)
    return {
        "metric": "sharded_d1_overhead",
        "config": name,
        "n_reads": len(reads),
        "device_reads_per_s": round(len(reads) / dev_t, 1),
        "sharded_d1_reads_per_s": round(len(reads) / sh_t, 1),
        "device_steady_s": round(dev_t, 3),
        "sharded_steady_s": round(sh_t, 3),
        "overhead_x": round(sh_t / dev_t, 2),
        "lines_equal": dev_lines == sh_lines,
        "overlaps": len(dev_lines),
    }


def main():
    # --scale40k: the reference-scale comparison (at 40k the sharded
    # backend rides the same wide path; a 1024-read run measures
    # overheads only)
    if "--scale40k" in sys.argv:
        reads, _, _ = B.make_reads_placed(40_000, seed=B.SEED + 3)
        print(json.dumps(run_config("scale40k", reads, settles=1, reps=3)),
              flush=True)
        return
    print(json.dumps(run_config("primary1024", B.make_reads())), flush=True)


if __name__ == "__main__":
    main()
