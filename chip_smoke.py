"""Smoke run of the overlapper on the GPU: the quickest proof that the
system starts on the card and that its output is still exact.

    python chip_smoke.py               # one GPU, phases 1-5 below
    python chip_smoke.py --four-cards  # only the sharded run on four GPUs

Phases (each failure raises, so the script exits non-zero):
  1. device: nvidia-smi's name and power limit, the JAX version and
     devices; no GPU -> exit non-zero, no result
  2. kernel parity at real widths, exact: the XLA min-reduce against the
     numpy oracle (w_max 1 and 8), the fast pass + exact automaton
     against the C++ scorer, the sort and merge pair structures against
     each other; compiled memory analyses of the sketch-chunk and wide
     score programs
  3. primary: 1024 reads through the CLI in-process (narrow device vote)
  4. filtered2k: the tf-idf filter path through the CLI (``-f``)
  5. scale40k: 40,000 lognormal reads (wide join-once vote)
Phases 3-5 compare the line-set sha256 with the native reference port
(native/mhap_cpu.cc) run on the same reads in the same call.  Timings are
smoke timings labelled with the card, not benchmark numbers.

The last stdout line is {"ok": true, "device": {platform, kind, count}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import bench  # noqa: E402  (outside a checkout this import fails)
from mhap_tpu.utils.device import gpu_device_info, nvidia_smi_lines  # noqa: E402

K1 = 16


def _ready(x):
    import jax

    return jax.block_until_ready(x)


def _timed(fn, *a, **kw):
    t0 = time.perf_counter()
    out = _ready(fn(*a, **kw))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------- phase 1

def check_device(count: int) -> dict:
    """Device phase: SystemExit unless JAX's devices are >= ``count``
    GPUs.  Prints nvidia-smi's line for every card."""
    import jax

    info = gpu_device_info()
    if info["count"] < count:
        raise SystemExit(f"need {count} GPUs, JAX sees {info['count']}")
    for line in nvidia_smi_lines():
        print(line)
    print(f"jax {jax.__version__} devices {jax.devices()}")
    return info


# ---------------------------------------------------------------- phase 2

def repeat_reads(n: int, length: int, copies: int, seed: int) -> list[str]:
    """Random reads of ``length`` bases, each holding ``copies`` copies of
    one 300-base segment: its k-mers occur ``copies`` times (weights up to
    ``copies``), every other k-mer once."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for _ in range(n):
        r = bases[rng.integers(0, 4, length)]
        seg = r[:300].copy()
        for c in range(1, copies):
            r[c * 400:c * 400 + 300] = seg
        out.append(bytes(r).decode("ascii"))
    return out


def minreduce_args(reads: list[str], w_max: int) -> tuple:
    """Device inputs (hi, lo, weight, active, tiebreak) of the weighted
    min-reduce over one [len(reads), n] k-mer batch.  w_max 1 is the
    pipeline's base rung (every valid position active, position
    tiebreak); larger caps are the deduplicated weighted form with
    weight = occurrence count."""
    import jax.numpy as jnp

    from mhap_tpu.ops import minhash as M
    from mhap_tpu.ops import murmur3 as H3

    L = max(len(r) for r in reads)
    seq = np.zeros((len(reads), L), np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        seq[i, :len(r)] = np.frombuffer(r.encode("ascii"), np.uint8)
        lens[i] = len(r)
    n = L - K1 + 1
    hi, lo = H3.kmer_hashes_128(jnp.asarray(seq), K1, 0)
    valid = jnp.asarray(np.arange(n)[None, :] < (lens[:, None] - K1 + 1))
    if w_max == 1:
        idx = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), hi.shape)
        args = (hi, lo, jnp.ones(hi.shape, jnp.int32), valid, idx)
    else:
        g = M.sort_and_count(hi, lo, valid)
        w = jnp.where(g["first"], g["count"], 0)
        top = int(w.max())
        assert top <= w_max, f"weight {top} exceeds w_max {w_max}"
        args = (g["hi"], g["lo"], w, g["first"] & (w > 0), g["tiebreak"])
    return args


def minreduce_parity(reads: list[str], w_max: int, num_hashes: int = 512,
                     n_check: int = 8) -> float:
    """The XLA weighted min-reduce (ops/minhash.weighted_min_reduce) on
    minreduce_args against the numpy oracle (oracle/sketch.weighted_minhash)
    on the first ``n_check`` reads.  Returns the steady call's host-clock
    seconds."""
    from mhap_tpu.ops import minhash as M
    from mhap_tpu.oracle import sketch as O

    args = minreduce_args(reads, w_max)
    run = lambda: M.weighted_min_reduce(*args, num_hashes=num_hashes,
                                        w_max=w_max)
    _ready(run())
    got, dt = _timed(run)
    got = np.asarray(got)
    rw = -1.0 if w_max == 1 else 0.9  # all weights 1 / weight = count
    for i in range(min(n_check, len(reads))):
        want = O.weighted_minhash(
            O.sequence_kmer_hashes_128(reads[i], K1), num_hashes,
            repeat_weight=rw)
        np.testing.assert_array_equal(got[i], want,
                                      err_msg=f"min-reduce row {i}")
    return dt


def sample_pairs(store, placements, n_pairs: int, seed: int):
    """Score-lane (query row, candidate row) pairs over a sketch store:
    half genome neighbours (mostly true overlaps, either strand), most of
    the rest random rows, and 1/32 self pairs (identical sketches overflow
    the fast pass's record cap and take the exact automaton)."""
    rng = np.random.default_rng(seed)
    rows_of = {}
    for r, h in enumerate(store.header_id):
        rows_of.setdefault(int(h), []).append(r)
    hids = np.asarray(sorted(rows_of))
    order = hids[np.argsort([placements[h - 1][0] for h in hids])]
    N = len(store.header_id)
    qi, ci = [], []
    for t in range(n_pairs):
        kind = t % 32
        if kind == 0:
            q = c = int(rng.integers(0, N))
        elif kind < 16:
            k = int(rng.integers(0, len(order) - 3))
            a = order[k]
            b = order[k + int(rng.integers(1, 4))]
            q = rows_of[int(a)][0]
            c = int(rng.choice(rows_of[int(b)]))
        else:
            q, c = (int(x) for x in rng.integers(0, N, 2))
        qi.append(q)
        ci.append(c)
    return np.asarray(qi, np.int32), np.asarray(ci, np.int32)


def scorer_parity(ov, store, qi, ci) -> int:
    """TpuOverlapper.score_pairs -- the XLA fast pass, then the exact
    automaton for the lanes it flags -- against the C++ scorer
    (native/scorer.h through ctypes) on every lane, exactly.  Returns the
    number of lanes the automaton re-scored."""
    from mhap_tpu.utils.native import score_pair

    slow0 = ov.slow_pair_count
    score, raw, edges = ov.score_pairs(store, store, qi, ci)
    oh, op = store.ordered_h, store.ordered_p
    om, nk = store.ordered_m, store.num_kmers
    k2, shift = ov.cfg["ordered_kmer_size"], ov.cfg["max_shift"]

    def sk(r):
        return np.stack([oh[r, :om[r]], op[r, :om[r]]], axis=1)

    bad = []
    for t, (q, c) in enumerate(zip(qi, ci)):
        want = score_pair(sk(q), int(nk[q]), sk(c), int(nk[c]), k2, shift)
        got = (score[t], raw[t], *(int(e) for e in edges[t]))
        if got != want:
            bad.append((t, int(q), int(c), got, want))
    assert not bad, f"{len(bad)} scorer lanes differ from C++: {bad[:3]}"
    return ov.slow_pair_count - slow0


def structure_parity(ov, store, qi, ci):
    """The sort and merge master structures (ops/scorer) on the same
    gathered sketch rows must agree on every output.  Returns the steady
    host-clock seconds of (sort, merge)."""
    import jax
    import jax.numpy as jnp

    from mhap_tpu.ops import scorer as SC

    oh, op, om, _ = ov._dev_store(store)
    q, c = jnp.asarray(qi), jnp.asarray(ci)
    args = (oh[q], op[q], om[q], oh[c], op[c], om[c])
    outs, times = [], []
    for f in (SC._sorted_pair_structure_sort,
              SC._sorted_pair_structure_merge):
        fn = jax.jit(jax.vmap(f))
        _ready(fn(*args))
        out, dt = _timed(fn, *args)
        outs.append({k: np.asarray(v) for k, v in out.items()})
        times.append(dt)
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k],
                                      err_msg=f"structure key {k}")
    return tuple(times)


def print_memory_analyses(ov, width: int, n_rows: int, n_pairs: int):
    """compiled.memory_analysis() of the rc-paired sketch-chunk program at
    a bucket ``width`` and of the wide score-slice program over a store
    of ``n_rows`` rows with an ``n_pairs`` pair buffer."""
    import jax
    import jax.numpy as jnp

    from mhap_tpu.pipeline.overlapper import _sketch_packed_rc_jit

    sds = jax.ShapeDtypeStruct
    cfg = ov.cfg
    S = cfg["ordered_sketch_size"]
    R2 = ov.ROWS // 2
    sketch = _sketch_packed_rc_jit.lower(
        sds((R2, width // 4), jnp.uint8), sds((R2,), jnp.int32), 0,
        k1=cfg["kmer_size"], k2=cfg["ordered_kmer_size"],
        H=cfg["num_hashes"], S=S, w_cap=1, R2=R2).compile()
    print(f"memory_analysis sketch chunk [{R2} fwd rows, width {width}]: "
          f"{sketch.memory_analysis()}")
    N_pad = (n_rows // 1024 + 1) * 1024
    gf, T = ov._wide_score_fn(N_pad, N_pad, True)
    cols = (sds((N_pad, S), jnp.int32), sds((N_pad, S), jnp.int32),
            sds((N_pad,), jnp.int32), sds((N_pad,), jnp.int32))
    buf = sds((n_pairs,), jnp.int32)
    wide = gf.lower(*cols, *cols, buf, buf,
                    sds((), jnp.int32)).compile()
    print(f"memory_analysis wide score slice [T={T}, N={N_pad}]: "
          f"{wide.memory_analysis()}")


# ------------------------------------------------------------ phases 3-5

def check_lines(name: str, lines, native, expect: int | None):
    got = bench.lineset_sha256(lines)
    want = bench.lineset_sha256(native)
    print(f"{name}: {len(lines)} lines, native {len(native)}; "
          f"sha256 {got} native {want} equal={got == want}")
    assert got == want, f"{name}: line set differs from the native port"
    if expect is not None:
        assert len(lines) == expect, f"{name}: expected {expect} lines"


def cli_phase(name: str, reads, work: str, args=(), expect=None) -> float:
    """Run the CLI's main(argv) in-process on ``reads`` written as FASTA
    (``-s reads.fa`` plus ``args``), M4 output captured to a file, then
    the native port on the same FASTA with the same ``args``.  Returns
    the CLI's wall seconds."""
    from mhap_tpu.cli import main as cli

    fa = os.path.join(work, f"{name}.fa")
    bench.write_fasta(reads, fa)
    m4, log = os.path.join(work, f"{name}.m4"), os.path.join(work,
                                                            f"{name}.log")
    t0 = time.perf_counter()
    with open(m4, "w") as out, open(log, "w") as err, \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["-s", fa, *args])
    dt = time.perf_counter() - t0
    assert rc == 0, f"{name}: CLI exit status {rc}"
    with open(log) as f:
        for ln in f:
            if ln.startswith(("Exact-automaton fallback pairs",
                              "Total time")):
                print(f"{name}: cli stderr: {ln.strip()}")
    with open(m4) as f:
        lines = f.read().splitlines()
    check_lines(name, lines, bench.native_lines(fa, extra=args), expect)
    return dt


def scale_phase(reads, work: str, expect=None):
    """scale40k through TpuOverlapper.overlap_self (cold, then steady),
    against the native port.  Returns (cold s, steady s, stats)."""
    import jax

    from mhap_tpu.pipeline.overlapper import TpuOverlapper

    ov = TpuOverlapper()
    t0 = time.perf_counter()
    lines = ov.overlap_self(reads)
    cold = time.perf_counter() - t0
    stats = dict(ov.stats, slow_pair_count=ov.slow_pair_count)
    t0 = time.perf_counter()
    again = ov.overlap_self(reads)
    steady = time.perf_counter() - t0
    assert again == lines, "scale40k: second run differs from the first"
    fa = os.path.join(work, "scale40k.fa")
    bench.write_fasta(reads, fa)
    check_lines("scale40k", lines, bench.native_lines(fa), expect)
    stats["peak_bytes_in_use"] = jax.devices()[0].memory_stats()[
        "peak_bytes_in_use"]
    return cold, steady, stats


def four_card_phase(reads, work: str, expect=None) -> float:
    """ShardedOverlapper over a 1-D mesh of every visible GPU on the
    scale40k reads, against the native port (whose line set phase 5 pins
    equal to the single-card run).  Returns wall seconds."""
    from mhap_tpu.parallel.sharded import ShardedOverlapper, make_mesh

    ov = ShardedOverlapper(make_mesh())
    t0 = time.perf_counter()
    lines = ov.overlap_self(reads)
    dt = time.perf_counter() - t0
    fa = os.path.join(work, "scale40k.fa")
    bench.write_fasta(reads, fa)
    check_lines(f"scale40k on {ov.D} cards", lines,
                bench.native_lines(fa), expect)
    return dt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded scale40k path on 4 GPUs")
    opt = ap.parse_args(argv)
    info = check_device(4 if opt.four_cards else 1)

    from mhap_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}")
    card = f"{info['name']}, {info['power_limit']}"
    smoke = f"smoke timing, not a benchmark ({card})"
    big, _, _ = bench.make_reads_placed(40_000, seed=bench.SEED + 3)

    with tempfile.TemporaryDirectory() as work:
        if opt.four_cards:
            dt = four_card_phase(big, work, bench.EXPECTED_SCALE40K)
            print(f"scale40k on 4 cards: {dt:.1f} s cold [{smoke}]")
        else:
            from mhap_tpu.index.joinvote import QC
            from mhap_tpu.pipeline.overlapper import TpuOverlapper

            # phase 2: parity at real widths
            width = -(-max(len(r) for r in big) // 512) * 512
            for w_max in (1, 8):
                rs = repeat_reads(512, width, max(w_max, 4),
                                  seed=10 + w_max)
                dt = minreduce_parity(rs, w_max)
                print(f"min-reduce H=512 w_max={w_max} [512, "
                      f"{width - K1 + 1}] == oracle; steady {dt * 1e3:.2f}"
                      f" ms [{smoke}]")
            reads, placements, _ = bench.make_reads_placed(
                1024, seed=bench.SEED + 7)
            ov = TpuOverlapper()
            store = ov.sketch_reads(reads)
            qi, ci = sample_pairs(store, placements, 4096, seed=5)
            n_slow = scorer_parity(ov, store, qi, ci)
            print(f"scorer S=1536: {len(qi)} pairs == C++ scorer; "
                  f"{n_slow} lanes took the exact automaton")
            qi, ci = sample_pairs(store, placements, ov.WIDE_SCORE_T,
                                  seed=6)
            t_sort, t_merge = structure_parity(ov, store, qi, ci)
            print(f"pair structure S=1536 x {len(qi)} lanes: sort == "
                  f"merge; steady sort {t_sort * 1e3:.2f} ms merge "
                  f"{t_merge * 1e3:.2f} ms [{smoke}]")
            # the wide path's pair buffer: 32 * QC pairs per stage-C chunk
            print_memory_analyses(ov, width, 2 * len(big),
                                  -(-len(big) // QC) * 32 * QC)
            del ov, store

            # phases 3-5: end to end against the native port
            prim = bench.make_reads()
            for run in ("cold", "warm"):
                dt = cli_phase("primary", prim, work,
                               expect=bench.EXPECTED_PRIMARY)
                print(f"primary 1024 reads: {dt:.2f} s {run} [{smoke}]")
            fpath = os.path.join(work, "kmers.txt")
            freads, _ = bench.filtered_reads(2048, fpath)
            dt = cli_phase("filtered2k", freads, work, args=("-f", fpath),
                           expect=bench.EXPECTED_FILTERED2K)
            print(f"filtered2k: {dt:.2f} s cold [{smoke}]")
            cold, steady, st = scale_phase(big, work,
                                           bench.EXPECTED_SCALE40K)
            print(f"scale40k: {cold:.1f} s cold, {steady:.1f} s steady "
                  f"[{smoke}]")
            print(f"scale40k: direct-fallback queries "
                  f"{st['direct_fallback_queries']}, exact-automaton "
                  f"lanes {st['slow_pair_count']}, peak_bytes_in_use "
                  f"{st['peak_bytes_in_use']}")

    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["device_kind"],
        "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
