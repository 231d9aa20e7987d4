"""Scale proof: sharded overlap of a large synthetic read set on the
8-device virtual CPU mesh, line-set-compared against the independently
written native CPU implementation (native/mhap_cpu.cc).

It runs the band-sharded postings design at a read count past anything a
dense all-pairs vote could touch, with per-device memory
O(N/D + N*H/D + chunk).

Usage:  python scripts/scale_test.py [n_reads] [--skip-native]
Prints the result as one JSON line.
"""
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def make_reads(n_reads, seed=20260817, coverage=25.0):
    """Lognormal length distribution (ONT-like), reads tiled over a random
    genome sized for the target coverage."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    lens = np.clip(rng.lognormal(np.log(1100), 0.45, n_reads), 500,
                   8000).astype(int)
    genome_len = int(lens.sum() / coverage)
    genome = rng.integers(0, 4, genome_len + 10000)
    reads = []
    err = 0.10
    for L in lens:
        pos = int(rng.integers(0, genome_len))
        raw = genome[pos:pos + int(L * 1.15)]
        r = rng.random(len(raw))
        out = []
        for i in range(len(raw)):
            if r[i] < err * 0.4:
                out.append(raw[i])
                out.append(rng.integers(0, 4))
            elif r[i] < err * 0.7:
                continue
            elif r[i] < err:
                out.append(rng.integers(0, 4))
            else:
                out.append(raw[i])
            if len(out) >= L:
                break
        arr = np.asarray(out[:L], dtype=np.int64)
        reads.append(bytes(bases[arr]).decode())
    return reads


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() \
        else 50_000
    t0 = time.time()
    print(f"generating {n} reads ...", flush=True)
    reads = make_reads(n)
    print(f"  {time.time()-t0:.0f}s; total bases "
          f"{sum(map(len, reads))/1e6:.1f}M", flush=True)

    result = {"n_reads": n, "total_bases": int(sum(map(len, reads)))}

    from mhap_tpu.parallel.sharded import ShardedOverlapper, make_mesh

    # the reference's fast preset (--settings 2, MhapMain.java:158-177):
    # a blessed config that keeps the CPU-mesh run tractable at 50k reads
    CFG = dict(num_hashes=256, threshold=0.80, ordered_sketch_size=1000,
               ordered_kmer_size=14)
    mesh = make_mesh(jax.devices())
    result["n_devices"] = int(mesh.devices.size)
    result["config"] = "fast preset (--settings 2)"
    ov = ShardedOverlapper(mesh, CFG, pair_chunk=8192)
    t0 = time.time()
    lines = ov.overlap_self(reads)
    dt = time.time() - t0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    result.update(sharded_seconds=round(dt, 1), overlaps=len(lines),
                  sharded_reads_per_s=round(n / dt, 1),
                  peak_rss_gb=round(rss, 2),
                  slow_pairs=ov.slow_pair_count,
                  pairs_scored=ov.stats["sequences_fully_compared"])
    print(f"sharded: {dt:.0f}s, {len(lines)} overlaps, rss {rss:.1f}GB",
          flush=True)

    if "--skip-native" not in sys.argv:
        fa = os.path.join("/tmp", f"scale_{n}.fa")
        with open(fa, "w") as f:
            for i, r in enumerate(reads):
                f.write(f">r{i}\n{r}\n")
        binary = os.path.join(ROOT, "native", "build", "mhap_cpu")
        t0 = time.time()
        out = subprocess.run([binary, "-s", fa, "--num-threads",
                              str(os.cpu_count()),
                              "--num-hashes", "256", "--threshold", "0.80",
                              "--ordered-sketch-size", "1000",
                              "--ordered-kmer-size", "14"],
                             capture_output=True, text=True, check=True)
        dtn = time.time() - t0
        native = sorted(out.stdout.strip().splitlines())
        os.unlink(fa)
        result.update(native_seconds=round(dtn, 1),
                      native_overlaps=len(native),
                      lines_equal=(native == lines))
        print(f"native: {dtn:.0f}s, {len(native)} overlaps, "
              f"equal={native == lines}", flush=True)
        if native != lines:
            sn, sl = set(native), set(lines)
            print("only-native:", list(sn - sl)[:3])
            print("only-sharded:", list(sl - sn)[:3])

    print(json.dumps(result))


if __name__ == "__main__":
    main()
