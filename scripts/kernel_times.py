"""Device time of the XLA kernels at real widths, from jax.profiler traces.

    python scripts/kernel_times.py [--e2e]

Runs on the GPU only.  Each program is compiled, then traced alone over
REPS steady calls; its device time is the union of the intervals in which
any kernel ran on the card, per call.  The span from a call's first
kernel start to its last kernel end, minus that busy time, is the idle
time inside the call (launch gaps, e.g. between the steps of the
min-reduce's lax.scan).  Programs:

  minreduce_w1 / minreduce_w8  weighted min-reduce, H=512, 512 rows at the
                               widest sketch bucket of the scale40k reads
  score_sort / score_merge     the wide score-slice program (gather + fast
                               pass + pack) over 32768 lanes at S=1536,
                               with the sort or the merge pair structure
  struct_sort / struct_merge   the pair structure alone on the same lanes
  automaton                    the exact while-loop automaton over one
                               128-lane dispatch of flagged pairs
--e2e adds one traced steady scale40k overlap_self: wall time, device
busy time and idle share of that run.

Prints one line per program, then all results as one JSON line.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke as cs  # noqa: E402
from mhap_tpu.utils.device import gpu_device_info  # noqa: E402

REPS = 5


def device_intervals(trace_dir: str):
    """(start_ns, end_ns) of every kernel on the GPU planes of the one
    trace under ``trace_dir``, and the names of the lines they came from.
    Stream lines carry the kernels; other device lines (if any) are
    summaries of the same time and are skipped."""
    import jax

    path, = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    data = jax.profiler.ProfileData.from_file(path)
    ivs, names = [], set()
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for ln in streams or lines:
            names.add(ln.name)
            for ev in ln.events:
                ivs.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    return sorted(ivs), sorted(names)


def busy_ns(ivs) -> float:
    """Length of the union of sorted intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in ivs:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def trace_program(name: str, fn, reps: int = REPS) -> dict:
    """Compile + warm ``fn``, then trace ``reps`` calls; device busy and
    in-call idle time per call, in microseconds."""
    import jax

    jax.block_until_ready(fn())
    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td):
            t0 = time.perf_counter()
            for _ in range(reps):
                jax.block_until_ready(fn())
            wall = time.perf_counter() - t0
        ivs, lines = device_intervals(td)
    span = (ivs[-1][1] - ivs[0][0]) if ivs else 0.0
    busy = busy_ns(ivs)
    out = dict(device_us=busy / reps / 1e3,
               span_us=span / reps / 1e3,
               idle_in_span=(1.0 - busy / span) if span else None,
               host_wall_us=wall / reps * 1e6, n_kernels=len(ivs) // reps,
               trace_lines=lines)
    print(f"{name}: device {out['device_us']:.1f} us/call, span "
          f"{out['span_us']:.1f} us, idle in span "
          f"{out['idle_in_span']}, {out['n_kernels']} kernels/call, host "
          f"wall {out['host_wall_us']:.1f} us/call", flush=True)
    return out


def main() -> int:
    import jax
    import jax.numpy as jnp

    from mhap_tpu.ops import minhash as M
    from mhap_tpu.ops import scorer as SC
    from mhap_tpu.pipeline.overlapper import TpuOverlapper
    from mhap_tpu.utils.compile_cache import enable_compile_cache

    info = gpu_device_info()
    enable_compile_cache()
    card = f"{info['name']}, {info['power_limit']}"
    print(f"device: {card} ({info['device_kind']})")
    res = dict(device=info, reps=REPS, programs={})
    big, _, _ = bench.make_reads_placed(40_000, seed=bench.SEED + 3)
    width = -(-max(len(r) for r in big) // 512) * 512

    for w_max in (1, 8):
        args = cs.minreduce_args(
            cs.repeat_reads(512, width, max(w_max, 4), seed=10 + w_max),
            w_max)
        res["programs"][f"minreduce_w{w_max}"] = trace_program(
            f"minreduce_w{w_max} [512, {width - cs.K1 + 1}]",
            lambda: M.weighted_min_reduce(*args, num_hashes=512,
                                          w_max=w_max))

    reads, placements, _ = bench.make_reads_placed(1024,
                                                   seed=bench.SEED + 7)
    ov = TpuOverlapper()
    store = ov.sketch_reads(reads)
    T = ov.WIDE_SCORE_T
    qi, ci = cs.sample_pairs(store, placements, T, seed=6)
    q_dev = ov._dev_store(store)
    bq, bc = jnp.asarray(qi), jnp.asarray(ci)
    base = ov._dev_i32(0)
    default = SC._sorted_pair_structure
    for label, struct in (("sort", SC._sorted_pair_structure_sort),
                          ("merge", SC._sorted_pair_structure_merge)):
        # a fresh overlapper traces a fresh program with this structure
        SC._sorted_pair_structure = struct
        o = TpuOverlapper()
        gf, _ = o._wide_score_fn(q_dev[0].shape[0], q_dev[0].shape[0],
                                 True)
        res["programs"][f"score_{label}"] = trace_program(
            f"score_{label} [T={T}, S=1536]",
            lambda gf=gf: gf(*q_dev, *q_dev, bq, bc, base))
        fn = jax.jit(jax.vmap(struct))
        oh, op, om, _ = q_dev
        sargs = (oh[bq], op[bq], om[bq], oh[bc], op[bc], om[bc])
        res["programs"][f"struct_{label}"] = trace_program(
            f"struct_{label} [T={T}, S=1536]",
            lambda fn=fn: fn(*sargs))
    SC._sorted_pair_structure = default

    flagged = np.nonzero(ov._score_dispatch(store, store, qi, ci)
                         ["needs_slow"])[0][:ov.SLOW_QUANTUM]
    auto = SC.make_score_pairs(0.2, 1536)
    ar = [jnp.asarray(x) for x in (qi[flagged], ci[flagged])]
    aargs = tuple(c[ar[0]] for c in q_dev) + tuple(c[ar[1]] for c in q_dev)
    res["programs"]["automaton"] = trace_program(
        f"automaton [{len(flagged)} flagged lanes, S=1536]",
        lambda: auto(*aargs))

    if "--e2e" in sys.argv:
        ov = TpuOverlapper()
        ov.overlap_self(big)
        with tempfile.TemporaryDirectory() as td:
            with jax.profiler.trace(td):
                t0 = time.perf_counter()
                ov.overlap_self(big)
                wall = time.perf_counter() - t0
            ivs, lines = device_intervals(td)
        busy = busy_ns(ivs) / 1e9
        res["scale40k"] = dict(wall_s=wall, device_busy_s=busy,
                               idle_share=1.0 - busy / wall,
                               trace_lines=lines)
        print(f"scale40k traced steady run: wall {wall:.2f} s, device busy "
              f"{busy:.2f} s, idle share {1.0 - busy / wall:.3f}")

    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
