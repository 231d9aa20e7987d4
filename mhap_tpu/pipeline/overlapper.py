"""End-to-end overlapper pipeline on the JAX device path.

The device path mirrors the reference pipeline (main/MhapMain.java:377-552;
impl/MinHashSearch.java; impl/AbstractMatchSearch.java) with a dense batched
dataflow instead of thread pools:

  encode reads -> 2-bit packed, length-bucketed [B, L/4] batches (one host
    -> device transfer per bucket; non-ACGT reads take a uint8 side path)
    -> murmur3 k-mer hash kernels (ops/murmur3.py)
    -> weighted-MinHash min-reduce (ops/minhash.py)
    -> bottom-k sort kernel (ops/bottomk.py)
  -> DEVICE-RESIDENT sketch store (columns never leave device memory on
     the overlap path; only packed reads go in and accepted matches out)
  -> sorted-postings LSH vote on device (index/postings.py), with an
     escalation ladder (span_cap, top_k) and an exact host fallback
  -> batched two-pass merge scorer (ops/scorer.py), one dispatch per run
  -> host float64 mash-identity conversion + M4 text emission

Output parity: the emitted line *set* is identical to the oracle
(mhap_tpu/oracle/pipeline.py) and to the independently written native CPU
implementation (native/mhap_cpu.cc).

Weight handling: stage-1 weights are the per-read k-mer occurrence counts
(tf mode, the default when no filter file is given: repeat_weight=0.9 with
no filter -> weight = count, MinHashSketch.java:95-128).  The min-reduce is
compiled for a static per-batch weight cap; batches whose true max weight
exceeds the cap escalate to a higher-cap variant (weights are tiny for real
reads, so the base cap almost always holds).
"""

from __future__ import annotations

import os
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# MHAP_WIDE_PROFILE=1: print blocking per-stage wall times of the wide
# path (dev-only; the blocks serialize the pipeline, so profiled runs
# are slower than production runs)
_WPROF = os.environ.get("MHAP_WIDE_PROFILE") == "1"


def _wp(label: str, t0: float, *arrs) -> float:
    """Profiling helper: block on `arrs`, print elapsed, return new t0."""
    if not _WPROF:
        return t0
    for a in arrs:
        try:
            a.block_until_ready()
        except AttributeError:
            pass
    t1 = time.perf_counter()
    # stderr: stdout carries M4 overlap lines in the CLI
    print(f"[wprof] {label}: {t1 - t0:.3f}s", file=sys.stderr, flush=True)
    return t1

from ..oracle import scorer as _oscorer
from ..ops import bottomk as _bottomk
from ..ops import minhash as _minhash
from ..ops import murmur3 as _murmur3
from ..ops import scorer as _kscorer

DEFAULTS = dict(
    kmer_size=16,
    num_hashes=512,
    num_min_matches=3,
    threshold=0.78,
    ordered_kmer_size=12,
    ordered_sketch_size=1536,
    max_shift=0.2,
    min_store_length=0,
    min_olap_length=116,
    repeat_weight=0.9,
)

_RC_TABLE = np.arange(256, dtype=np.uint8)
for _a, _b in [("A", "T"), ("C", "G"), ("M", "K"), ("R", "Y"), ("W", "W"),
               ("S", "S"), ("V", "B"), ("H", "D"), ("N", "N")]:
    _RC_TABLE[ord(_a)] = ord(_b)
    _RC_TABLE[ord(_b)] = ord(_a)

# ACGT -> 2-bit code; everything else -> 4 (irregular marker)
_ACGT_MAP = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _ACGT_MAP[ord(_c)] = _i


def _rc_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of ASCII codes (utils/Utils.java rc(), IUPAC)."""
    return _RC_TABLE[codes[::-1]]


# in-kernel escalation rung of the w_cap==1 sketch kernel: (row budget,
# weight cap).  Rows with repeated k-mers are re-sketched exactly inside
# the chunk program up to this weight; the host row kernel handles only
# weights beyond ESC_INKERNEL[1] (or rows past the budget).
ESC_INKERNEL = (16, 4)

# max_w sentinel: a k-mer's occurrence count exceeded the weight-LUT's
# CMAX columns, so the row's exact tf-idf weight is unknown on device --
# the host filtered path recomputes it (device caps cannot fix it)
W_SENT = 1 << 20


def _filter_match(hi, lo, t_hi, t_lo, W: int):
    """Device tf-idf table probe: index of each 64-bit k-mer hash in the
    sorted filter table ([K+1] uint32 halves, ascending (hi, lo) with a
    trailing never-matching pad), or K+1 for a miss.  ``W`` (static) is
    the longest equal-hi run in the table, so a searchsorted on the hi
    halves plus a W-wide linear probe finds any (hi, lo) exactly
    (FrequencyCounts.java:267 fraction-map probe, vectorized)."""
    Kp = t_hi.shape[0]  # K + 1 (incl. pad)
    a = jnp.searchsorted(t_hi, hi).astype(jnp.int32)
    m = jnp.full(hi.shape, Kp, jnp.int32)  # miss row
    for j in range(W):
        idx = jnp.minimum(a + j, Kp - 1)
        hit = (t_hi[idx] == hi) & (t_lo[idx] == lo) & (m == Kp)
        m = jnp.where(hit, idx, m)
    return m


class OptimisticSketchMiss(Exception):
    """Deferred-flags sketch found a zero-ngram row or weight escalation
    after downstream work was already dispatched; redo strictly."""


def _bucket_len(n: int, quantum: int = 256) -> int:
    """Length bucket: next power of two (>= quantum).  Pow2 snapping keeps
    the number of compiled kernel shapes logarithmic in the read-length
    spread (a lognormal length distribution would otherwise compile tens
    of bucket variants) at a bounded padding cost."""
    return max(quantum, 1 << (n - 1).bit_length())


class SketchStore:
    """Dense sketch columns for a set of oriented reads.

    Mirrors impl/SequenceSketch.java's bundle, as columns:
      header_id [N] int64, is_fwd [N] bool, length [N] int32 (host numpy),
      minhash [N, H] int32, ordered_h/ordered_p [N, S] int32,
      ordered_m [N] int32 (valid entries), num_kmers [N] int32.

    The five big columns may live on DEVICE (``dev(name)``) and are
    materialized to host numpy lazily on first attribute access -- the
    overlap path never pulls them; only ``.dat``/npz export and the exact
    host fallbacks do.
    """

    COLS = ("minhash", "ordered_h", "ordered_p", "ordered_m", "num_kmers")

    def __init__(self, header_id, is_fwd, length, minhash=None,
                 ordered_h=None, ordered_p=None, ordered_m=None,
                 num_kmers=None, headers=None, dev_cols=None):
        self.header_id = np.asarray(header_id, dtype=np.int64)
        self.is_fwd = np.asarray(is_fwd, dtype=bool)
        self.length = np.asarray(length, dtype=np.int32)
        self.headers = (headers if headers is not None
                        else [None] * len(self.header_id))
        vals = dict(minhash=minhash, ordered_h=ordered_h,
                    ordered_p=ordered_p, ordered_m=ordered_m,
                    num_kmers=num_kmers)
        self._host = {k: np.asarray(v) for k, v in vals.items()
                      if v is not None}
        self._dev = dict(dev_cols or {})
        self._dev_cache = None       # scorer-padded device columns
        self._dev_postings = None    # device postings (vals, sids)

    def __len__(self):
        return len(self.header_id)

    @property
    def n_real(self) -> int:
        """Rows with a real sequence (header_id > 0); differs from len()
        only for keep-in-place sharded stores with padding rows."""
        return int(np.count_nonzero(self.header_id))

    def display(self, i: int) -> str:
        h = self.headers[i]
        return h if h is not None else str(int(self.header_id[i]))

    def dev(self, name: str):
        """Device-resident column (pushed from host on first use)."""
        if name not in self._dev:
            self._dev[name] = jnp.asarray(self._host[name])
        return self._dev[name]

    def _col(self, name: str) -> np.ndarray:
        if name not in self._host:
            self._host[name] = np.asarray(self._dev[name])
        return self._host[name]

    minhash = property(lambda self: self._col("minhash"))
    ordered_h = property(lambda self: self._col("ordered_h"))
    ordered_p = property(lambda self: self._col("ordered_p"))
    ordered_m = property(lambda self: self._col("ordered_m"))
    num_kmers = property(lambda self: self._col("num_kmers"))

    @staticmethod
    def concat(stores: list["SketchStore"]) -> "SketchStore":
        cols = {}
        for name in ("header_id", "is_fwd", "length"):
            cols[name] = np.concatenate([getattr(s, name) for s in stores])
        for name in SketchStore.COLS:
            cols[name] = np.concatenate([getattr(s, name) for s in stores])
        headers = [h for s in stores for h in s.headers]
        return SketchStore(headers=headers, **cols)


# ---------------- sketch kernels (jitted chunk programs) ----------------


def _v_to_ascii(v):
    # A=65 C=67 G=71 T=84
    return jnp.uint8(65) + jnp.where(
        v == 1, jnp.uint8(2), jnp.uint8(0)) + jnp.where(
        v == 2, jnp.uint8(6), jnp.uint8(0)) + jnp.where(
        v == 3, jnp.uint8(19), jnp.uint8(0))


def _unpack_2bit(packed, L: int):
    rep = jnp.repeat(packed, 4, axis=1)
    sh = ((jnp.arange(L, dtype=jnp.int32) % 4) * 2).astype(jnp.uint8)
    return (rep >> sh[None, :]) & jnp.uint8(3)


def _decode_2bit(packed, L: int):
    """[R, L/4] uint8 -> [R, L] ASCII codes (device)."""
    return _v_to_ascii(_unpack_2bit(packed, L))


def _decode_2bit_pair(packed, L: int):
    """[R, L/4] packed rows holding RIGHT-aligned reads -> (fwd, rc) ASCII
    code arrays [R, L].  The reverse complement is derived ON DEVICE (the
    host pushes only forward strands -- halves the transfer): with
    the read right-aligned at [L-len, L), complementing in 2-bit space
    (3 - v) and statically flipping the whole padded row yields the rc
    strand LEFT-aligned at [0, len) -- no per-row dynamic roll/gather."""
    v = _unpack_2bit(packed, L)
    return _v_to_ascii(v), _v_to_ascii(jnp.flip(jnp.uint8(3) - v, axis=1))


def _sketch_core(seq, lens, k1, k2, H, S, w_cap, start=None, filt=None,
                 filt_meta=None):
    """Whole sketch chunk: hash128 -> weighted min-reduce; hash32 ->
    bottom-k.  All outputs stay on device.

    ``start`` [B] i32 (None = zeros): per-row offset of the read within
    the padded row (device-derived rc strands sit left-aligned at 0 while
    their forward partners are right-aligned at L-len; see
    _decode_2bit_pair).  Valid k-mer windows are [start, start+len-k+1);
    ordered-sketch positions are returned read-relative (window - start).
    The min-reduce/bottom-k tiebreak stays the window index: it is
    start + read position, monotone per row, so first-occurrence
    semantics match the reference exactly.

    w_cap == 1 rung: the dedup sort (sort_and_count) is skipped entirely.
    With every weight clamped to 1, duplicates cannot change the
    min-reduce -- xorshift64 is a bijection, so two streams produce equal
    values iff they start from the same 64-bit hash, i.e. value ties only
    happen between copies of the SAME k-mer, and the position-index
    tiebreak then selects the first occurrence exactly as the reference's
    insertion-ordered map does (MinHashSketch.java:66-81,134-153).  A
    cheap duplicate-detection sort flags rows with repeated k-mers; the
    first ESC_ROWS flagged rows are then re-sketched EXACTLY in kernel at
    weight cap ESC_W (dedup sort + min-reduce on the gathered row subset)
    -- a host round trip saved on almost every bucket, since real read
    batches nearly always contain a few w=2..4 rows.  Handled rows report
    their exact max weight; rows beyond the budget report the lower bound
    ESC_W+1, and the host escalates anything > ESC_W with the row kernel
    (see _sketch_entries_device)."""
    n1 = seq.shape[1] - k1 + 1
    pos1 = jnp.arange(n1)[None, :]
    if start is None:
        valid1 = pos1 < (lens[:, None] - k1 + 1)
    else:
        valid1 = ((pos1 >= start[:, None])
                  & (pos1 < (start + lens)[:, None] - k1 + 1))
    hi, lo = _murmur3.kmer_hashes_128(seq, k1, 0)
    if filt is not None:
        # device tf-idf/legacy weighting: dedup sort, one table probe,
        # one weight-LUT gather (exact float64 weights precomputed host
        # side per (table row, count) -- freqfilter.device_tables);
        # counts beyond the LUT's CMAX flag the row with W_SENT for the
        # host filtered path (sketch/MinHashSketch.java:95-128 weights,
        # FrequencyCounts.java:290-311 scaledIdf)
        t_hi, t_lo, wlut = filt
        W, CMAX, counts_matter = filt_meta
        g = _minhash.sort_and_count(hi, lo, valid1)
        m = _filter_match(g["hi"], g["lo"], t_hi, t_lo, W)
        cidx = jnp.clip(g["count"], 1, CMAX) - 1
        w = wlut[m * CMAX + cidx]
        w = jnp.where(g["first"], w, 0)
        active = g["first"] & (w > 0)
        n_valid = jnp.sum(active, axis=1).astype(jnp.int32)
        max_w = jnp.max(jnp.where(active, w, 0), axis=1)
        if counts_matter:
            over = jnp.any(g["first"] & (g["count"] > CMAX), axis=1)
            max_w = jnp.where(over, jnp.int32(W_SENT), max_w)
        sketch = _minhash.weighted_min_reduce(
            g["hi"], g["lo"], jnp.minimum(w, w_cap), active, g["tiebreak"],
            num_hashes=H, w_max=w_cap)
    elif w_cap == 1:
        B, n = hi.shape
        dup = _minhash.dup_rows(hi, lo, valid1)
        n_valid = jnp.sum(valid1, axis=1).astype(jnp.int32)
        idx = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), (B, n))
        sketch = _minhash.weighted_min_reduce(
            hi, lo, jnp.ones((B, n), jnp.int32), valid1, idx,
            num_hashes=H, w_max=1)
        # in-kernel escalation rung over the flagged rows
        ESC_ROWS, ESC_W = ESC_INKERNEL
        R_e = min(ESC_ROWS, B)
        rows_i = jnp.arange(B, dtype=jnp.int32)
        ranks = jnp.cumsum(dup.astype(jnp.int32)) - 1
        handled = dup & (ranks < R_e)
        rows_e = jax.lax.sort(jnp.where(handled, rows_i, B))[:R_e]
        used = rows_e < B
        rr = jnp.where(used, rows_e, 0)
        g = _minhash.sort_and_count(hi[rr], lo[rr],
                                    valid1[rr] & used[:, None])
        w = jnp.where(g["first"], g["count"], 0)
        active = g["first"] & (w > 0)
        exact_w = jnp.max(jnp.where(active, w, 0), axis=1)
        mh_e = _minhash.weighted_min_reduce(
            g["hi"], g["lo"], jnp.minimum(w, ESC_W), active, g["tiebreak"],
            num_hashes=H, w_max=ESC_W)
        tgt = jnp.where(used, rows_e, B)
        sketch = sketch.at[tgt].set(mh_e, mode="drop")
        max_w = jnp.where(dup, jnp.int32(ESC_W + 1), jnp.int32(1))
        max_w = max_w.at[tgt].set(exact_w, mode="drop")
    else:
        g = _minhash.sort_and_count(hi, lo, valid1)
        w = jnp.where(g["first"], g["count"], 0)
        active = g["first"] & (w > 0)
        n_valid = jnp.sum(active, axis=1).astype(jnp.int32)
        max_w = jnp.max(jnp.where(active, w, 0), axis=1)
        sketch = _minhash.weighted_min_reduce(
            g["hi"], g["lo"], jnp.minimum(w, w_cap), active, g["tiebreak"],
            num_hashes=H, w_max=w_cap)
    n2 = seq.shape[1] - k2 + 1
    pos2 = jnp.arange(n2)[None, :]
    if start is None:
        valid2 = pos2 < (lens[:, None] - k2 + 1)
    else:
        valid2 = ((pos2 >= start[:, None])
                  & (pos2 < (start + lens)[:, None] - k2 + 1))
    h32 = _murmur3.kmer_hashes_32(seq, k2, 0)
    oh, op, om = _bottomk.bottom_sketch(h32, valid2, sketch_size=S)
    if start is not None:
        op = jnp.where(jnp.arange(op.shape[1])[None, :] < om[:, None],
                       op - start[:, None], op)
    return dict(minhash=sketch, n_valid=n_valid, max_w=max_w,
                ordered_h=oh, ordered_p=op, ordered_m=om)


@partial(jax.jit, static_argnames=("k1", "k2", "H", "S", "w_cap", "R",
                                   "filt_meta"))
def _sketch_packed_jit(packed, lens, start, k1, k2, H, S, w_cap, R,
                       filt=None, filt_meta=None):
    """Sketch R rows of a device-resident 2-bit-packed bucket starting at
    row ``start`` (traced: one compile per bucket shape, not per chunk)."""
    pr = jax.lax.dynamic_slice(packed, (start, 0), (R, packed.shape[1]))
    lr = jax.lax.dynamic_slice(lens, (start,), (R,))
    seq = _decode_2bit(pr, packed.shape[1] * 4)
    return _sketch_core(seq, lr, k1, k2, H, S, w_cap, filt=filt,
                        filt_meta=filt_meta)


def _interleave_rc(packed_rows, lens_rows):
    """[R2, W] packed right-aligned fwd rows -> ([2*R2, L] ASCII codes of
    interleaved (fwd, rc) strands, repeated lens, per-row start offsets).
    Row 2i is the forward strand (right-aligned, start = L - len); row
    2i+1 is its device-derived reverse complement (left-aligned, start
    0)."""
    R2 = packed_rows.shape[0]
    L = packed_rows.shape[1] * 4
    fwd, rc = _decode_2bit_pair(packed_rows, L)
    seq = jnp.stack([fwd, rc], axis=1).reshape(2 * R2, L)
    lens2 = jnp.repeat(lens_rows, 2)
    start_f = (jnp.int32(L) - lens_rows).astype(jnp.int32)
    start = jnp.stack(
        [start_f, jnp.zeros_like(start_f)], axis=1).reshape(2 * R2)
    return seq, lens2, start


@partial(jax.jit, static_argnames=("k1", "k2", "H", "S", "w_cap", "R2",
                                   "filt_meta"))
def _sketch_packed_rc_jit(packed, lens, row0, k1, k2, H, S, w_cap, R2,
                          filt=None, filt_meta=None):
    """Sketch R2 packed FWD rows starting at ``row0`` into 2*R2 output
    rows: each forward strand (pushed right-aligned) is paired with its
    reverse complement derived on device -- the host never materializes
    or transfers rc strands (SequenceSketchStreamer.java enqueues both
    strands; here the host transfers one)."""
    pr = jax.lax.dynamic_slice(packed, (row0, 0), (R2, packed.shape[1]))
    lr = jax.lax.dynamic_slice(lens, (row0,), (R2,))
    seq, lens2, start = _interleave_rc(pr, lr)
    return _sketch_core(seq, lens2, k1, k2, H, S, w_cap, start=start,
                        filt=filt, filt_meta=filt_meta)


@partial(jax.jit, static_argnames=("k1", "H", "w_cap", "filt_meta"))
def _sketch_minhash_codes_jit(seq, lr, k1, H, w_cap, filt=None,
                              filt_meta=None):
    """Stage-1 sketch ONLY, over raw ASCII code rows at a higher weight
    cap -- the host escalation path (rows whose max k-mer occurrence
    count exceeds the in-kernel rung's cap).  Skips the bottom-k and
    hash32 work, which is cap-independent.  Also returns the EXACT
    per-row max weight so the caller can escalate further when this
    rung's cap is still insufficient."""
    n1 = seq.shape[1] - k1 + 1
    valid1 = jnp.arange(n1)[None, :] < (lr[:, None] - k1 + 1)
    hi, lo = _murmur3.kmer_hashes_128(seq, k1, 0)
    g = _minhash.sort_and_count(hi, lo, valid1)
    if filt is not None:
        t_hi, t_lo, wlut = filt
        W, CMAX, counts_matter = filt_meta
        m = _filter_match(g["hi"], g["lo"], t_hi, t_lo, W)
        cidx = jnp.clip(g["count"], 1, CMAX) - 1
        w = wlut[m * CMAX + cidx]
    else:
        w = g["count"]
    w = jnp.where(g["first"], w, 0)
    active = g["first"] & (w > 0)
    max_w = jnp.max(jnp.where(active, w, 0), axis=1)
    if filt is not None and filt_meta[2]:
        over = jnp.any(g["first"] & (g["count"] > filt_meta[1]), axis=1)
        max_w = jnp.where(over, jnp.int32(W_SENT), max_w)
    mh = _minhash.weighted_min_reduce(
        g["hi"], g["lo"], jnp.minimum(w, w_cap), active, g["tiebreak"],
        num_hashes=H, w_max=w_cap)
    return mh, max_w


@partial(jax.jit, static_argnames=("k1", "k2", "H", "S", "w_cap",
                                   "filt_meta"))
def _sketch_fused_jit(seq, lens, k1, k2, H, S, w_cap, filt=None,
                      filt_meta=None):
    """uint8 ASCII variant (irregular/non-ACGT rows, filter path)."""
    out = _sketch_core(seq, lens, k1, k2, H, S, w_cap, filt=filt,
                       filt_meta=filt_meta)
    return (out["minhash"], out["n_valid"], out["max_w"],
            out["ordered_h"], out["ordered_p"], out["ordered_m"])


@partial(jax.jit, static_argnames=("k1",))
def _sketch_hash128_jit(seq, k1):
    return _murmur3.kmer_hashes_128(seq, k1, 0)


@partial(jax.jit, static_argnames=("k2", "S"))
def _sketch_bottom_jit(seq, lens, k2, S):
    n2 = seq.shape[1] - k2 + 1
    valid2 = jnp.arange(n2)[None, :] < (lens[:, None] - k2 + 1)
    h32 = _murmur3.kmer_hashes_32(seq, k2, 0)
    return _bottomk.bottom_sketch(h32, valid2, sketch_size=S)


@jax.jit
def _gather_cols_jit(mh, oh, op, om, pos):
    return mh[pos], oh[pos], op[pos], om[pos]


class TpuOverlapper:
    """Single-chip overlapper. Multi-chip sharding lives in parallel/."""

    # device-resident filtered sketching (tf-idf/legacy weight modes);
    # the sharded subclass keeps the host filter flow for now
    FILTER_DEVICE = True
    # weight-cap ladder for the filtered kernels: tf-idf weights are
    # ~range x count (range default 3.0), so the base rung sits at 16
    # (covers counts <= 5 at the default scale) instead of the plain
    # path's w=1 fast rung
    W_CAPS_FILT = (16, 64, 256, 1024)

    def __init__(self, cfg=None, w_caps=(1, 16, 128, 512),
                 pair_chunk: int = 512, kmer_filter=None):
        self.cfg = dict(DEFAULTS)
        if cfg:
            self.cfg.update(cfg)
        self.w_caps = tuple(w_caps)
        self.pair_chunk = pair_chunk
        self.kmer_filter = kmer_filter  # VectorFrequencyFilter or None
        self._filt_dev = "unset"  # lazy device filter tables (or None)
        # record capacity 1024 < 2S: shrinks the shift-median/optimize sort
        # widths; the rare overflowing lanes (near-duplicate reads) re-run
        # exactly on the host oracle via needs_slow
        self._score_fast = _kscorer.make_score_pairs_fast(
            self.cfg["max_shift"], self.cfg["ordered_sketch_size"],
            cap=min(512, 2 * self.cfg["ordered_sketch_size"]))
        self.slow_pair_count = 0  # observability: host-oracle fallbacks
        self._gather_score_cache: dict = {}
        self.long_window = 1 << 17  # streaming window for very long reads
        # device_vote: LSH vote with the on-device postings kernel
        # (index/postings.py) behind an escalation ladder; span-cap overflow
        # or top-k saturation escalates, ultimately to the exact host vote.
        # On for the GPU; every other backend (the CPU tests) keeps the
        # host vote to avoid per-shape compile churn -- dedicated tests
        # force device_vote=True for parity coverage.
        self.device_vote = jax.default_backend() == "gpu"
        self.num_threads = None  # --num-threads: host-side pools (tools)
        # overlap flows skip the sketch flags sync and verify after the
        # find pass (see _check_pending); a miss turns this off
        self._defer_flags = True
        # search statistics (MinHashSearch.java:51-58 atomics equivalent)
        self.stats = dict(matches_processed=0, sequences_searched=0,
                          elements_processed=0, sequences_hit=0,
                          sequences_fully_compared=0,
                          direct_fallback_queries=0,
                          minhash_search_time=0.0, sort_merge_time=0.0)

    # ---------------- sketching ----------------

    def _filter_device(self):
        """Device filter tables (freqfilter.device_tables) for the
        current filter + weight mode, or None when the mode needs the
        host flow (remove_unique 1/2) / no tables (tf mode, no filter).
        Returns ((t_hi, t_lo, wlut_flat) device arrays,
        (W, CMAX, counts_matter) static meta) or None."""
        if self._filt_dev != "unset":
            return self._filt_dev
        out = None
        if self.kmer_filter is not None and self.FILTER_DEVICE:
            t = self.kmer_filter.device_tables(
                float(self.cfg["repeat_weight"]))
            if t is not None:
                out = ((jnp.asarray(t["t_hi"]), jnp.asarray(t["t_lo"]),
                        jnp.asarray(t["wlut"])),
                       (t["W"], t["cmax"], t["counts_matter"]))
        self._filt_dev = out
        return out

    def _filt_kw(self) -> dict:
        fd = self._filter_device()
        return dict(filt=fd[0], filt_meta=fd[1]) if fd is not None else {}

    def _caps_thresh(self):
        """(weight-cap ladder, escalation threshold) for the active
        sketch mode.  Plain: base rung w=1 with the in-kernel ESC_W
        escalation; filtered: the W_CAPS_FILT ladder (exact max_w from
        the weight LUT, no in-kernel rung)."""
        if self._filter_device() is not None:
            return self.W_CAPS_FILT, self.W_CAPS_FILT[0]
        return self.w_caps, ESC_INKERNEL[1]

    def _sketch_batch(self, codes: np.ndarray, lens: np.ndarray):
        """codes: [B, L] uint8 (padded). Returns host numpy arrays
        (minhash [B,H], mh_valid [B] bool, oh, op, om, num_kmers).

        Host-materialized variant used by the filter path; the no-filter
        path uses the device-resident flow in sketch_reads."""
        cfg = self.cfg
        k1, k2 = cfg["kmer_size"], cfg["ordered_kmer_size"]
        H, S = cfg["num_hashes"], cfg["ordered_sketch_size"]

        if self.kmer_filter is not None:
            seq = jnp.asarray(codes)
            lens_j = jnp.asarray(lens)
            n1 = codes.shape[1] - k1 + 1
            valid1 = jnp.arange(n1)[None, :] < (lens_j[:, None] - k1 + 1)
            hi, lo = _sketch_hash128_jit(seq, k1)
            mh, mh_valid = self._minhash_filtered(hi, lo, np.asarray(valid1))
            h32_out = _sketch_bottom_jit(seq, lens_j, k2, S)
            oh, op, om = h32_out
        else:
            out = _sketch_fused_jit(jnp.asarray(codes), jnp.asarray(lens),
                                    k1, k2, H, S, self.w_caps[0])
            sketch, n_valid, max_w, oh, op, om = out
            mh = np.array(sketch)
            nv = np.asarray(n_valid)
            maxw = np.asarray(max_w)
            redo = maxw > ESC_INKERNEL[1]
            for cap in self.w_caps[1:]:
                if not redo.any():
                    break
                out2 = _sketch_fused_jit(jnp.asarray(codes),
                                         jnp.asarray(lens),
                                         k1, k2, H, S, cap)
                mh[redo] = np.asarray(out2[0])[redo]
                redo = redo & (maxw > cap)
            if redo.any():
                raise RuntimeError(
                    f"k-mer weight exceeds largest cap {self.w_caps[-1]}")
            mh_valid = nv > 0
        num_kmers = np.maximum(lens - k2 + 1, 0).astype(np.int32)
        return (mh, mh_valid, np.asarray(oh), np.asarray(op),
                np.asarray(om), num_kmers)

    def _minhash_filtered(self, hi, lo, window_valid):
        """Filtered sketch: device hashing, vectorized host keepKmer +
        tf-idf weights (exact Java double semantics, see freqfilter.py),
        device min-reduce."""
        cfg = self.cfg
        H = cfg["num_hashes"]
        f = self.kmer_filter
        h64 = (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | \
            np.asarray(lo, dtype=np.uint64)
        valid = window_valid & f.keep_mask(h64)

        # group duplicates per row: sort by (invalid, hash), stable
        B, n = h64.shape
        o1 = np.argsort(h64, axis=1, kind="stable")
        inval_s = np.take_along_axis(~valid, o1, 1)
        o2 = np.argsort(inval_s, axis=1, kind="stable")
        order = np.take_along_axis(o1, o2, 1).astype(np.int32)
        s_h = np.take_along_axis(h64, order, 1)
        s_valid = np.take_along_axis(valid, order, 1)
        prev_same = np.zeros((B, n), bool)
        prev_same[:, 1:] = s_h[:, 1:] == s_h[:, :-1]
        first = s_valid & ~prev_same
        # run lengths via position-difference of first indices
        # (vectorized over the whole batch: per-row loops cost ~0.5s per
        # [512, n] batch on a one-core host at 40k-repeat scale)
        counts = np.zeros((B, n), np.int64)
        nvalid_row = s_valid.sum(axis=1)
        fr, fc = np.nonzero(first)
        if len(fr):
            # end of run i = start of the next run in the same row, else
            # the row's valid count
            ends = np.empty(len(fr), np.int64)
            same_row = fr[:-1] == fr[1:]
            ends[:-1] = np.where(same_row, fc[1:], nvalid_row[fr[:-1]])
            ends[-1] = nvalid_row[fr[-1]]
            counts[fr, fc] = ends - fc
        w = np.zeros((B, n), np.int64)
        fm = first.reshape(-1)
        if fm.any():
            w.reshape(-1)[fm] = f.weights(
                s_h.reshape(-1)[fm], counts.reshape(-1)[fm],
                cfg["repeat_weight"])
        active = first & (w > 0)
        nv = active.sum(axis=1)
        # snap the compiled weight cap to the next power of two: this is
        # only a jit-variant bound (the kernel runs w_max advances per
        # slot for EVERY k-mer, so over-snapping to an escalation rung
        # multiplies the whole min-reduce)
        w_max = max(int(w.max()) if w.size else 1, 1)
        w_max = 1 << (w_max - 1).bit_length()
        s_hi = jnp.asarray((s_h >> np.uint64(32)).astype(np.uint32))
        s_lo = jnp.asarray((s_h & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        mh = _minhash.weighted_min_reduce(
            s_hi, s_lo, jnp.asarray(w.astype(np.int32)),
            jnp.asarray(active), jnp.asarray(order),
            num_hashes=H, w_max=w_max)
        return np.asarray(mh), nv > 0

    def _sketch_rows_host_filt(self, codes_list) -> np.ndarray:
        """Exact host filtered stage-1 sketch of a few code rows (the
        device flow's escape hatch when a k-mer count exceeds the weight
        LUT's CMAX): device hashing + the host float64 weight machinery
        (_minhash_filtered).  Returns the [n, H] minhash (numpy)."""
        cfg = self.cfg
        k1 = cfg["kmer_size"]
        L = _bucket_len(max(len(cd) for cd in codes_list))
        n = len(codes_list)
        sub = np.zeros((n, L), np.uint8)
        sl = np.zeros(n, np.int32)
        for t, cd in enumerate(codes_list):
            sub[t, :len(cd)] = cd
            sl[t] = len(cd)
        hi, lo = _sketch_hash128_jit(jnp.asarray(sub), k1)
        n1 = L - k1 + 1
        valid = np.arange(n1)[None, :] < (sl[:, None] - k1 + 1)
        mh, _nv = self._minhash_filtered(hi, lo, valid)
        return mh

    # reads longer than this stream through the windowed sketcher instead
    # of the dense length-bucketed batch (padding/bucket-explosion control;
    # SURVEY.md section 5 "long-context" guidance)
    LONG_READ_THRESHOLD = 1 << 17

    def _sketch_long(self, codes: np.ndarray, window: int | None = None):
        """Streaming sketch of one very long read: hash in overlapping
        windows (bounded device memory), dedup/count on host, then one
        single-row device min-reduce over the unique k-mers and a merged
        bottom-k.  Bit-identical to the dense path (the weighted-MinHash
        min and the bottom-k are mergeable across windows)."""
        window = window or self.long_window
        cfg = self.cfg
        k1, k2 = cfg["kmer_size"], cfg["ordered_kmer_size"]
        H, S = cfg["num_hashes"], cfg["ordered_sketch_size"]
        L = len(codes)

        # --- stage 1: windowed 128-bit hashing -> host u64 stream ---
        h64_parts = []
        for s in range(0, L - k1 + 1, window):
            e = min(L, s + window + k1 - 1)
            wlen = ((e - s + 255) // 256) * 256
            buf = np.zeros((1, wlen), np.uint8)
            buf[0, :e - s] = codes[s:e]
            hi, lo = _sketch_hash128_jit(jnp.asarray(buf), k1)
            n_here = e - s - k1 + 1
            h64 = (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | \
                np.asarray(lo, dtype=np.uint64)
            h64_parts.append(h64[0, :n_here])
        h64 = np.concatenate(h64_parts)

        if self.kmer_filter is not None:
            keep = self.kmer_filter.keep_mask(h64)
            h64_kept = h64[keep]
        else:
            h64_kept = h64
        if len(h64_kept) == 0:
            return None
        keys, first_idx, counts = np.unique(
            h64_kept, return_index=True, return_counts=True)
        if self.kmer_filter is not None:
            w = self.kmer_filter.weights(keys, counts, cfg["repeat_weight"])
        else:
            w = counts.astype(np.int64)
        act = w > 0
        if not act.any():
            return None
        # single padded row over the unique k-mers
        U = len(keys)
        U_pad = max(256, ((U + 255) // 256) * 256)
        hi_r = np.zeros((1, U_pad), np.uint32)
        lo_r = np.zeros((1, U_pad), np.uint32)
        w_r = np.zeros((1, U_pad), np.int32)
        tb_r = np.full((1, U_pad), np.int32(0x7FFFFFFF), np.int32)
        act_r = np.zeros((1, U_pad), bool)
        hi_r[0, :U] = (keys >> np.uint64(32)).astype(np.uint32)
        lo_r[0, :U] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        w_r[0, :U] = np.minimum(w, np.iinfo(np.int32).max)
        tb_r[0, :U] = np.minimum(first_idx, np.iinfo(np.int32).max)
        act_r[0, :U] = act
        w_max = max(1, int(w[act].max()))
        for capw in self.w_caps:
            if w_max <= capw:
                w_max = capw
                break
        mh = np.asarray(_minhash.weighted_min_reduce(
            jnp.asarray(hi_r), jnp.asarray(lo_r), jnp.asarray(w_r),
            jnp.asarray(act_r), jnp.asarray(tb_r),
            num_hashes=H, w_max=w_max))[0]

        # --- stage 2: windowed bottom-k, merged across windows ---
        parts = []
        for s in range(0, L - k2 + 1, window):
            e = min(L, s + window + k2 - 1)
            wlen = ((e - s + 255) // 256) * 256
            buf = np.zeros((1, wlen), np.uint8)
            buf[0, :e - s] = codes[s:e]
            n_here = e - s - k2 + 1
            oh, op, om = _sketch_bottom_jit(
                jnp.asarray(buf), jnp.asarray([n_here + k2 - 1], np.int32),
                k2, S)
            m = int(np.asarray(om)[0])
            part = np.stack([np.asarray(oh)[0, :m],
                             np.asarray(op)[0, :m] + s], axis=1)
            parts.append(part)
        allp = np.concatenate(parts)
        order = np.lexsort((allp[:, 1], allp[:, 0]))
        m = min(S, L - k2 + 1)
        merged = allp[order[:m]].astype(np.int32)
        return mh, merged, L - k2 + 1

    ROWS = 512  # fixed row-tile: bounds jit variants to (bucket_len,)
    D = 1       # devices (ShardedOverlapper overrides)

    # -- dispatch hooks (ShardedOverlapper re-targets these to shard_map) --

    def _host_arr(self, x) -> np.ndarray:
        """Materialize a device array on the host (the multi-process
        sharded subclass routes this through a replicating jit)."""
        return np.asarray(x)

    def _push_bucket(self, packed: np.ndarray, lens: np.ndarray):
        """Move one packed bucket to the accelerator (handle is opaque to
        the caller; the sharded subclass defers the transfer per chunk)."""
        return (jnp.asarray(packed), jnp.asarray(lens))

    def _sketch_chunk(self, handle, s: int, cap: int, R: int):
        cfg = self.cfg
        return _sketch_packed_jit(handle[0], handle[1], s,
                                  cfg["kmer_size"], cfg["ordered_kmer_size"],
                                  cfg["num_hashes"],
                                  cfg["ordered_sketch_size"], cap, R,
                                  **self._filt_kw())

    def _sketch_chunk_rc(self, handle, s: int, cap: int, R2: int):
        """R2 packed fwd rows at bucket row ``s`` -> 2*R2 interleaved
        (fwd, rc) sketch rows; rc strands derived on device."""
        cfg = self.cfg
        return _sketch_packed_rc_jit(handle[0], handle[1], s,
                                     cfg["kmer_size"],
                                     cfg["ordered_kmer_size"],
                                     cfg["num_hashes"],
                                     cfg["ordered_sketch_size"], cap, R2,
                                     **self._filt_kw())

    MINHASH_ROWQ = 64  # row quantum for the escalation codes kernel

    def _sketch_minhash_codes(self, codes_list, cap: int):
        """Stage-1 sketch of raw ASCII code rows at weight cap ``cap`` --
        the host escalation path: one u8 push + one dispatch covers every
        flagged row of the batch regardless of bucket/strand.  Returns
        ([n, H] device minhash, [n] exact max weight host array), or None
        when unsupported (the sharded subclass: chunk redo instead)."""
        cfg = self.cfg
        RQ = self.MINHASH_ROWQ
        n = len(codes_list)
        n_pad = ((n + RQ - 1) // RQ) * RQ
        L = _bucket_len(max(len(cd) for cd in codes_list))
        sub = np.zeros((n_pad, L), np.uint8)
        sl = np.zeros(n_pad, np.int32)
        for t, cd in enumerate(codes_list):
            sub[t, :len(cd)] = cd
            sl[t] = len(cd)
        mh, mw = _sketch_minhash_codes_jit(jnp.asarray(sub),
                                           jnp.asarray(sl),
                                           cfg["kmer_size"],
                                           cfg["num_hashes"], cap,
                                           **self._filt_kw())
        return mh[:n], np.asarray(mw)[:n]

    def _sketch_chunk_u8(self, sub, sl, cap: int):
        cfg = self.cfg
        o = _sketch_fused_jit(jnp.asarray(sub), jnp.asarray(sl),
                              cfg["kmer_size"],
                              cfg["ordered_kmer_size"], cfg["num_hashes"],
                              cfg["ordered_sketch_size"], cap,
                              **self._filt_kw())
        return dict(zip(("minhash", "n_valid", "max_w", "ordered_h",
                         "ordered_p", "ordered_m"), o))

    def sketch_reads(self, reads: list[str], headers=None, offset: int = 0,
                     do_rc: bool = True,
                     defer_flags: bool = False) -> SketchStore:
        """Sketch fwd (+rev) of every read with the reference's skip rules
        (SequenceSketchStreamer.java:123-177: drop < minOlapLength, skip
        zero-ngram reads; ids keep counting across dropped reads)."""
        cfg = self.cfg
        # filtered runs take the device flow too when the weight mode has
        # device tables (tf-idf / legacy at remove_unique 0 -- the
        # default and the reference's documented repeat regime); the
        # remove_unique 1/2 modes keep the host flow (per-k-mer
        # valid-set/bloom probes)
        host_flow = (self.kmer_filter is not None
                     and self._filter_device() is None
                     and not (self.cfg["repeat_weight"] >= 1.0
                              and self.kmer_filter.remove_unique == 0))
        entries = []  # (header_id, is_fwd, header, codes)
        for i, r in enumerate(reads):
            hid = i + 1 + offset
            if len(r) < cfg["min_olap_length"]:
                continue
            hdr = headers[i] if headers is not None else None
            codes = np.frombuffer(r.upper().encode("ascii"), dtype=np.uint8)
            entries.append((hid, True, hdr, codes))
            if do_rc:
                # device path: the rc entry shares the fwd byte array --
                # the accelerator derives the rc strand itself
                # (_sketch_packed_rc_jit); the host filter path needs the
                # real bytes
                entries.append((hid, False, hdr,
                                _rc_codes(codes) if host_flow else codes))
        if host_flow:
            return self._sketch_entries_host(entries, do_rc)
        return self._sketch_entries_device(entries, do_rc,
                                           defer=defer_flags)

    def _finalize_store(self, entries, do_rc, mh_valid, select_row):
        """Apply zero-ngram skip rules and build the metadata columns.

        select_row(sel) must return the 5 sketch columns for the kept
        entry indices ``sel`` (device or host arrays).
        """
        N = len(entries)
        # zero-ngram skip rules: fwd fails -> drop the read entirely;
        # rev fails -> keep fwd only (enqueue() + enqueueUntilFound()).
        keep = np.ones(N, bool)
        for j, (hid, fwd, hdr, codes) in enumerate(entries):
            if fwd and not mh_valid[j]:
                keep[j] = False
                if do_rc and j + 1 < N and entries[j + 1][0] == hid:
                    keep[j + 1] = False
            elif not fwd and not mh_valid[j]:
                keep[j] = False
        sel = np.nonzero(keep)[0]
        cols = select_row(sel)
        return SketchStore(
            header_id=np.asarray([entries[j][0] for j in sel], np.int64),
            is_fwd=np.asarray([entries[j][1] for j in sel], bool),
            length=np.asarray([len(entries[j][3]) for j in sel], np.int32),
            headers=[entries[j][2] for j in sel],
            **cols)

    def _sketch_entries_device(self, entries, do_rc,
                               defer: bool = False) -> SketchStore:
        """Device-resident sketching: 2-bit packed transfers in, sketch
        columns stay in device memory, one flags readback."""
        cfg = self.cfg
        k1, k2 = cfg["kmer_size"], cfg["ordered_kmer_size"]
        H, S = cfg["num_hashes"], cfg["ordered_sketch_size"]
        ROWS = self.ROWS
        N = len(entries)
        caps, esc_thresh = self._caps_thresh()

        # step 2 = rc-paired scheme: entries alternate (fwd, rc) with the
        # rc entry sharing the fwd byte array; only forward strands are
        # packed (right-aligned) and pushed -- the device derives rc
        # (_sketch_packed_rc_jit).  Halves the transfer + the host
        # packing loop.
        step = 2 if do_rc else 1
        by_bucket: dict[int, list[int]] = {}
        long_idx: list[int] = []
        for j in range(0, N, step):
            e = entries[j]
            if len(e[3]) >= self.LONG_READ_THRESHOLD:
                long_idx.extend(range(j, j + step))
            else:
                by_bucket.setdefault(_bucket_len(len(e[3])), []).append(j)

        chunks = []      # dicts: out (device col dict), idxs (entry idx per
        #                  row, -1 padding), redo args for cap escalation
        R_in = ROWS // step  # packed rows per chunk (ROWS output rows)
        # push granularity: sub-buckets of SPLIT packed rows, so the
        # transfer of sub-bucket k+1 overlaps sub-bucket k's
        # sketch kernels run AND the host packing of sub-bucket k+1
        # overlaps the DMA of sub-bucket k (pushes are async enqueues;
        # one monolithic push serializes pack -> transfer instead)
        SPLIT = R_in
        sub_buckets = []
        for blen, idxs_all in sorted(by_bucket.items()):
            # trim the padded width to the bucket's true max length
            # (rounded to a 512 lane quantum): pow2 grouping bounds the
            # number of buckets, the trim kills most of the pow2 padding
            # waste -- every [B, n] sketch op scales with this width
            wmax = max(len(entries[j][3]) for j in idxs_all)
            wlen = min(blen, max(256, -(-wmax // 512) * 512))
            for s0 in range(0, len(idxs_all), SPLIT):
                sub_buckets.append((wlen, idxs_all[s0:s0 + SPLIT]))
        for blen, idxs in sub_buckets:
            nb = len(idxs)
            nb_pad = ((nb + R_in - 1) // R_in) * R_in
            codes = np.zeros((nb_pad, blen), np.uint8)
            lens = np.zeros(nb_pad, np.int32)
            for r, j in enumerate(idxs):
                c = entries[j][3]
                if step == 2:
                    codes[r, blen - len(c):] = c  # right-aligned (rc flip)
                else:
                    codes[r, :len(c)] = c
                lens[r] = len(c)
            m = _ACGT_MAP[codes]
            if step == 2:
                pos_ok = np.arange(blen)[None, :] >= (blen - lens[:, None])
            else:
                pos_ok = np.arange(blen)[None, :] < lens[:, None]
            irr_rows = np.nonzero(((m == 4) & pos_ok).any(axis=1))[0]
            m[m == 4] = 0
            packed = (m[:, 0::4] | (m[:, 1::4] << 2) | (m[:, 2::4] << 4)
                      | (m[:, 3::4] << 6)).astype(np.uint8)
            handle = self._push_bucket(packed, lens)
            # output-space row -> entry index (irregular rows blanked: the
            # packed lanes hold garbage for them and must neither claim
            # the entry nor drive weight escalation -- the u8 side chunk
            # below owns them)
            row_idx = np.full(nb_pad * step, -1, np.int64)
            irr_set = set(int(r) for r in irr_rows)
            for r, j in enumerate(idxs):
                if r in irr_set:
                    continue
                row_idx[step * r] = j
                if step == 2:
                    row_idx[2 * r + 1] = j + 1
            for s in range(0, nb_pad, R_in):
                if step == 2:
                    out = self._sketch_chunk_rc(handle, s, caps[0],
                                                R_in)
                    c = dict(
                        out=out, idxs=row_idx[2 * s:2 * s + ROWS],
                        redo=lambda cap, handle=handle, s=s:
                            self._sketch_chunk_rc(handle, s, cap, R_in))
                else:
                    out = self._sketch_chunk(handle, s, caps[0],
                                             ROWS)
                    c = dict(
                        out=out, idxs=row_idx[s:s + ROWS],
                        redo=lambda cap, handle=handle, s=s:
                            self._sketch_chunk(handle, s, cap, ROWS))
                chunks.append(c)
            if len(irr_rows):
                # rows with non-ACGT codes: uint8 side path (exact hashes,
                # host-materialized rc strands -- irregular reads are rare)
                ni = len(irr_rows) * step
                rq = max(8, self.D)
                ni_pad = ((ni + rq - 1) // rq) * rq
                sub = np.zeros((ni_pad, blen), np.uint8)
                sl = np.zeros(ni_pad, np.int32)
                ridx = np.full(ni_pad, -1, np.int64)
                t = 0
                for r in irr_rows:
                    j = idxs[int(r)]
                    c = entries[j][3]
                    sub[t, :len(c)] = c
                    sl[t] = len(c)
                    ridx[t] = j
                    t += 1
                    if step == 2:
                        rcc = _rc_codes(c)
                        sub[t, :len(rcc)] = rcc
                        sl[t] = len(rcc)
                        ridx[t] = j + 1
                        t += 1
                out = self._sketch_chunk_u8(sub, sl, caps[0])
                chunks.append(dict(
                    out=out, idxs=ridx,
                    redo=lambda cap, sub=sub, sl=sl:
                        self._sketch_chunk_u8(sub, sl, cap)))

        # one readback: (n_valid, max_w) for every chunk row (the eager
        # concat/stack are device-side dispatches, not transfers)
        deferred_flags = None
        if chunks and defer and not long_idx:
            # OPTIMISTIC path (overlap flows only): the flags pull is the
            # sketch stage's only host sync (a host round trip) and at
            # steady state it never fires anything -- no zero-ngram rows,
            # no weight escalation.  Start an async copy, assume all rows
            # valid at weight cap w_caps[0], and verify AFTER the find
            # pass has pulled its own results (the async copy is done by
            # then, so the check is free).  A miss raises
            # OptimisticSketchMiss and the caller re-sketches strictly.
            deferred_flags = jnp.stack([
                jnp.concatenate([c["out"]["n_valid"] for c in chunks]),
                jnp.concatenate([c["out"]["max_w"] for c in chunks])])
            deferred_flags.copy_to_host_async()
            total = sum(len(c["idxs"]) for c in chunks)
            nv_all = np.ones(total, np.int32)
            mw_all = np.ones(total, np.int32)
        elif chunks:
            flags = self._host_arr(jnp.stack([
                jnp.concatenate([c["out"]["n_valid"] for c in chunks]),
                jnp.concatenate([c["out"]["max_w"] for c in chunks])]))
            nv_all, mw_all = flags[0], flags[1]
        else:
            nv_all = mw_all = np.zeros(0, np.int32)

        # weight-cap escalation: recompute the stage-1 sketch of rows whose
        # max k-mer weight exceeds the in-kernel rung's cap.  max_w is
        # exact for rows the in-kernel rung handled and a LOWER BOUND
        # (ESC_INKERNEL[1] + 1) for flagged rows past its budget, so after
        # each redo the now-exact weight is re-checked and still-over rows
        # escalate to the next rung.  ALL flagged rows -- every chunk,
        # every bucket, fwd and rc -- go through ONE codes-kernel dispatch
        # per rung (host round trips, not the kernel, set its cost);
        # chunk redo where that path is unsupported (sharded subclass).
        offs = np.cumsum([0] + [len(c["idxs"]) for c in chunks])
        for ci, c in enumerate(chunks):
            c["mw"] = np.asarray(mw_all[offs[ci]:offs[ci + 1]])

        def chunk_redo(c, need):
            real = c["idxs"] >= 0
            for cap in caps[1:]:
                if cap < need:
                    continue
                c["out"] = c["redo"](cap)
                mw2 = np.asarray(c["out"]["max_w"])
                need = int(mw2[real].max()) if real.any() else 0
                if need <= cap:
                    return
            raise RuntimeError(
                f"k-mer weight exceeds largest cap {caps[-1]}")

        items = []  # (chunk, chunk-local row, entry index)
        sent_items = []  # filtered rows with a count beyond the LUT CMAX
        for c in chunks:
            real = c["idxs"] >= 0
            for r in np.nonzero(real & (c["mw"] > esc_thresh))[0]:
                if int(c["mw"][r]) >= W_SENT:
                    sent_items.append((c, int(r), int(c["idxs"][r])))
                else:
                    items.append((c, int(r), int(c["idxs"][r])))
        if sent_items:
            # a k-mer count exceeded the device weight LUT: the exact
            # tf-idf weight needs the host float64 path for these rows
            # (rare: low-complexity reads with >CMAX copies of a k-mer)
            codes_list = []
            for c, r, j in sent_items:
                e = entries[j]
                codes_list.append(e[3] if e[1] else _rc_codes(e[3]))
            new_mh = self._sketch_rows_host_filt(codes_list)
            per_chunk: dict = {}
            for t, (c, r, _) in enumerate(sent_items):
                per_chunk.setdefault(id(c), (c, []))[1].append((r, t))
            for c, pairs in per_chunk.values():
                c["out"] = dict(c["out"])
                loc = jnp.asarray([p[0] for p in pairs])
                sel = np.asarray([p[1] for p in pairs])
                c["out"]["minhash"] = c["out"]["minhash"].at[loc].set(
                    jnp.asarray(new_mh[sel]))
        if items:
            need = max(int(c["mw"][r]) for c, r, _ in items)
            pend = np.arange(len(items))
            mutated: set = set()
            unsupported = resolved = False
            for cap in caps[1:]:
                if cap < need:
                    continue
                codes_list = []
                for i in pend:
                    e = entries[items[i][2]]
                    # device-rc scheme: rc entries share the fwd bytes
                    codes_list.append(e[3] if e[1] else _rc_codes(e[3]))
                res = self._sketch_minhash_codes(codes_list, cap)
                if res is None:
                    unsupported = True  # sharded: chunk redo below
                    break
                new_mh, new_mw = res
                # write rows back into their chunks (async device updates)
                per_chunk: dict = {}
                for t, i in enumerate(pend):
                    c, r, _ = items[i]
                    per_chunk.setdefault(id(c), (c, []))[1].append((r, t))
                for c, pairs in per_chunk.values():
                    if id(c) not in mutated:
                        c["out"] = dict(c["out"])
                        mutated.add(id(c))
                    loc = jnp.asarray([p[0] for p in pairs])
                    sel = jnp.asarray([p[1] for p in pairs])
                    c["out"]["minhash"] = c["out"]["minhash"].at[loc].set(
                        new_mh[sel])
                over = new_mw > cap
                if not over.any():
                    resolved = True
                    break
                pend, need = pend[over], int(new_mw[over].max())
            if unsupported:
                for c in {id(i[0]): i[0] for i in items}.values():
                    real = c["idxs"] >= 0
                    nd = int(c["mw"][real].max()) if real.any() else 0
                    if nd > esc_thresh:
                        chunk_redo(c, nd)
            elif not resolved:
                raise RuntimeError(
                    f"k-mer weight exceeds largest cap {caps[-1]}")

        # entry -> concat position (irregular rows override packed rows)
        pos_of = np.full(N, -1, np.int64)
        mh_valid = np.zeros(N, bool)
        for ci, c in enumerate(chunks):
            base = offs[ci]
            for r, j in enumerate(c["idxs"]):
                if j >= 0:
                    pos_of[j] = base + r
                    mh_valid[j] = nv_all[base + r] > 0

        # long reads: host streaming path, appended as extra rows (rc
        # entries share the fwd byte array in the device-rc scheme, so
        # materialize the rc strand here)
        long_rows = {}
        for j in long_idx:
            e = entries[j]
            res = self._sketch_long(e[3] if e[1] else _rc_codes(e[3]))
            if res is not None:
                long_rows[j] = res
                mh_valid[j] = True

        # context for subclasses that keep rows in place (parallel/sharded)
        self._entry_pos = pos_of
        self._long_rows = long_rows
        self._concat_fn = (lambda: {
            name: jnp.concatenate([c["out"][name] for c in chunks])
            for name in ("minhash", "ordered_h", "ordered_p", "ordered_m")
        }) if chunks else None

        def select_row(sel):
            nk = np.asarray([max(len(entries[j][3]) - k2 + 1, 0)
                             for j in sel], np.int32)
            dev_pos = pos_of[sel[pos_of[sel] >= 0]]
            if chunks:
                cat = {name: jnp.concatenate([c["out"][name]
                                              for c in chunks])
                       for name in ("minhash", "ordered_h", "ordered_p",
                                    "ordered_m")}
                g_mh, g_oh, g_op, g_om = _gather_cols_jit(
                    cat["minhash"], cat["ordered_h"], cat["ordered_p"],
                    cat["ordered_m"], jnp.asarray(dev_pos))
            else:
                g_mh = jnp.zeros((0, H), jnp.int32)
                g_oh = jnp.zeros((0, S), jnp.int32)
                g_op = jnp.zeros((0, S), jnp.int32)
                g_om = jnp.zeros((0,), jnp.int32)
            if not long_rows:
                return dict(num_kmers=nk,
                            dev_cols=dict(minhash=g_mh, ordered_h=g_oh,
                                          ordered_p=g_op, ordered_m=g_om,
                                          num_kmers=jnp.asarray(nk)))
            # rare: merge device rows + host long-read rows in sel order
            h = [np.asarray(g_mh), np.asarray(g_oh), np.asarray(g_op),
                 np.asarray(g_om)]
            rows = [[], [], [], []]
            di = 0
            for j in sel:
                if j in long_rows:
                    mh, merged, _ = long_rows[j]
                    oh = np.full(S, 0x7FFFFFFF, np.int32)
                    op = np.full(S, 0x7FFFFFFF, np.int32)
                    oh[:len(merged)] = merged[:, 0]
                    op[:len(merged)] = merged[:, 1]
                    for lst, v in zip(rows, (mh[None], oh[None], op[None],
                                             np.asarray([len(merged)],
                                                        np.int32))):
                        lst.append(v)
                else:
                    for lst, arr in zip(rows, h):
                        lst.append(arr[di:di + 1])
                    di += 1
            cat2 = [np.concatenate(r) if r else a for r, a in zip(rows, h)]
            return dict(minhash=cat2[0], ordered_h=cat2[1],
                        ordered_p=cat2[2], ordered_m=cat2[3], num_kmers=nk)

        out_store = self._finalize_store(entries, do_rc, mh_valid,
                                         select_row)
        if deferred_flags is not None:
            real_mask = np.concatenate([c["idxs"] >= 0 for c in chunks])
            out_store._pending_flags = (deferred_flags, real_mask,
                                        esc_thresh)
        # the chunk closures pin every per-chunk sketch column AND the
        # packed read buckets on device; by now the store has gathered
        # its own columns, and keeping them doubles sketch memory (the
        # difference between fitting and OOMing at 100k reads)
        self._concat_fn = None
        chunks.clear()
        return out_store

    def _sketch_entries_host(self, entries, do_rc) -> SketchStore:
        """Host-materialized sketching (filter path + compatibility)."""
        cfg = self.cfg
        by_bucket: dict[int, list[int]] = {}
        long_idx: list[int] = []
        for j, e in enumerate(entries):
            if len(e[3]) >= self.LONG_READ_THRESHOLD:
                long_idx.append(j)
            else:
                by_bucket.setdefault(_bucket_len(len(e[3])), []).append(j)

        N = len(entries)
        H, S = cfg["num_hashes"], cfg["ordered_sketch_size"]
        minhash = np.zeros((N, H), np.int32)
        mh_valid = np.zeros(N, bool)
        ordered_h = np.zeros((N, S), np.int32)
        ordered_p = np.zeros((N, S), np.int32)
        ordered_m = np.zeros(N, np.int32)
        num_kmers = np.zeros(N, np.int32)

        ROWS = self.ROWS
        for blen, idxs in sorted(by_bucket.items()):
            wmax = max(len(entries[j][3]) for j in idxs)
            blen = min(blen, max(256, -(-wmax // 512) * 512))
            for s in range(0, len(idxs), ROWS):
                chunk = idxs[s:s + ROWS]
                B = ROWS if len(idxs) > ROWS else len(chunk)
                codes = np.zeros((B, blen), np.uint8)
                lens = np.zeros(B, np.int32)
                for r, j in enumerate(chunk):
                    c = entries[j][3]
                    codes[r, :len(c)] = c
                    lens[r] = len(c)
                mh, mhv, oh, op, om, nk = self._sketch_batch(codes, lens)
                ii = np.asarray(chunk)
                m = len(chunk)
                minhash[ii] = mh[:m]
                mh_valid[ii] = mhv[:m]
                ordered_h[ii] = oh[:m]
                ordered_p[ii] = op[:m]
                ordered_m[ii] = om[:m]
                num_kmers[ii] = nk[:m]

        for j in long_idx:
            res = self._sketch_long(entries[j][3])
            if res is not None:
                mh, merged, nk = res
                minhash[j] = mh
                mh_valid[j] = True
                ordered_h[j, :len(merged)] = merged[:, 0]
                ordered_p[j, :len(merged)] = merged[:, 1]
                ordered_h[j, len(merged):] = np.int32(0x7FFFFFFF)
                ordered_p[j, len(merged):] = np.int32(0x7FFFFFFF)
                ordered_m[j] = len(merged)
                num_kmers[j] = nk

        return self._finalize_store(
            entries, do_rc, mh_valid,
            lambda sel: dict(minhash=minhash[sel], ordered_h=ordered_h[sel],
                             ordered_p=ordered_p[sel],
                             ordered_m=ordered_m[sel],
                             num_kmers=num_kmers[sel]))

    # ---------------- LSH vote ----------------

    @staticmethod
    def build_postings(store: SketchStore):
        """Sorted postings over (position, hashValue): the array-based
        re-expression of MinHashSearch's 512 hash tables (:85-147).
        Host fallback; the default path uses index/postings.py on device."""
        N, H = store.minhash.shape
        pos = np.repeat(np.arange(H, dtype=np.int64), N)
        val = store.minhash.T.reshape(-1).astype(np.int64) & 0xFFFFFFFF
        key = (pos << 32) | val
        sid = np.tile(np.arange(N, dtype=np.int64), H)
        order = np.argsort(key, kind="stable")
        return key[order], sid[order]

    @staticmethod
    def vote(postings, query_mh: np.ndarray):
        """Vote counting for a query batch (MinHashSearch.java:161-204).

        Returns (q_idx, cand_idx, counts) arrays over candidate pairs."""
        keys, sids = postings
        Q, H = query_mh.shape
        qpos = np.broadcast_to(np.arange(H, dtype=np.int64), (Q, H))
        qval = query_mh.astype(np.int64) & 0xFFFFFFFF
        qkey = ((qpos << 32) | qval).reshape(-1)
        left = np.searchsorted(keys, qkey, side="left")
        right = np.searchsorted(keys, qkey, side="right")
        cnt = right - left
        tot = int(cnt.sum())
        if tot == 0:
            e = np.zeros(0, np.int64)
            return e, e, e
        # expand hit ranges
        hit_q = np.repeat(np.arange(Q * H, dtype=np.int64) // H, cnt)
        starts = np.repeat(left - np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
        hit_slot = np.arange(tot, dtype=np.int64) + starts
        hit_cand = sids[hit_slot]
        pair = (hit_q << 32) | hit_cand
        upair, votes = np.unique(pair, return_counts=True)
        return upair >> 32, upair & 0xFFFFFFFF, votes

    def _build_index(self, store: SketchStore):
        """Index handle for _find_matches: device postings by default."""
        if self.device_vote:
            from ..index.postings import build_postings_device

            if store._dev_postings is None:
                store._dev_postings = build_postings_device(
                    store.dev("minhash"))
            return ("dev", store._dev_postings, store)
        return ("host", self.build_postings(store), store)

    VOTE_CHUNK = 2048  # query rows per device vote dispatch (bounds the
    #                    [Qc, H, span_cap] hit expansion + sort width)
    # (span_cap, top_k) escalation ladder; _vote_level remembers the last
    # level that succeeded so steady-state runs pay for one dispatch per
    # chunk (span sizes scale with coverage, so low levels overflow on
    # every chunk of a deep dataset)
    VOTE_LADDER = ((16, 96), (64, 192), (256, 384), (1024, 512))

    def _vote_dispatch(self, index, queries: "SketchStore",
                       q_sel: np.ndarray):
        """Returns (q_idx, cand, votes, hits_total, distinct_hit) host
        arrays over candidate pairs with count >= num_min_matches,
        semantics matching MinHashSearch.findMatches (:161-225).

        Device path: chunked over queries with an escalation ladder over
        (span_cap, top_k); any remaining overflow/saturation falls back to
        the exact host vote for that chunk."""
        kind, handle, store = index
        mm = self.cfg["num_min_matches"]
        if kind != "dev":
            q_idx, cand, votes = self.vote(handle, queries.minhash[q_sel])
            hits_total = int(votes.sum())
            distinct = len(q_idx)
            keep = votes >= mm
            return (q_idx[keep], cand[keep], votes[keep], hits_total,
                    distinct)

        from ..index.postings import vote_device_packed

        query_mh_dev = self._gather_rows_jit(
            queries.dev("minhash"), jnp.asarray(q_sel.astype(np.int32)))
        N = len(store)
        Q = int(query_mh_dev.shape[0])
        acc = dict(rows=[], cand=[], votes=[], hits=0, distinct=0)
        if not hasattr(self, "_vote_level"):
            self._vote_level = 0

        def host_fallback(s, e):
            # exact host vote for a stubborn range
            postings = getattr(store, "_host_postings", None)
            if postings is None:
                postings = self.build_postings(store)
                store._host_postings = postings
            qi, ci, vi = self.vote(postings, queries.minhash[q_sel][s:e])
            acc["hits"] += int(vi.sum())
            acc["distinct"] += len(qi)
            keep = vi >= mm
            acc["rows"].append(qi[keep] + s)
            acc["cand"].append(ci[keep])
            acc["votes"].append(vi[keep])

        def run_range(s, e, lvl):
            """Vote [s, e) at ladder level lvl, escalating sub-chunks that
            overflow; the query chunk shrinks as span_cap grows so the
            [QC, H, span_cap] hit buffer stays roughly constant."""
            if lvl >= len(self.VOTE_LADDER):
                host_fallback(s, e)
                return
            span_cap, top_k = self.VOTE_LADDER[lvl]
            QC = max(64, min(self.VOTE_CHUNK,
                             (self.VOTE_CHUNK * 32) // span_cap))
            # right-size to the range: padding 1k queries to a 2k chunk
            # would double the kernel work; 256-row quanta bound the
            # compile variants
            QC = min(QC, max(64, ((e - s + 255) // 256) * 256))
            K = min(top_k, N)
            for cs in range(s, e, QC):
                ce = min(cs + QC, e)
                # pad partial chunks to QC (bounds compile variants)
                qc = query_mh_dev[cs:ce]
                if ce - cs < QC:
                    qc = jnp.pad(qc, ((0, QC - (ce - cs)), (0, 0)))
                packed = np.asarray(vote_device_packed(
                    handle[0], handle[1], qc,
                    span_cap=span_cap, top_k=K,
                    min_matches=mm))[:ce - cs]
                cand = packed[:, :K]
                votes = packed[:, K:2 * K]
                overflow = packed[:, 2 * K]
                saturated = (K < N) & (votes[:, -1] > 0)
                if overflow.max() > 0 or np.any(saturated):
                    run_range(cs, ce, lvl + 1)
                    continue
                self._vote_level = lvl  # sticky: start here next time
                r, c = np.nonzero(votes > 0)
                acc["rows"].append(r.astype(np.int64) + cs)
                acc["cand"].append(cand[r, c].astype(np.int64))
                acc["votes"].append(votes[r, c].astype(np.int64))
                acc["hits"] += int(packed[:, 2 * K + 1].sum())
                acc["distinct"] += int(packed[:, 2 * K + 2].sum())

        run_range(0, Q, self._vote_level)
        if not acc["rows"]:
            z = np.zeros(0, np.int64)
            return z, z, z, acc["hits"], acc["distinct"]
        order_rows = np.concatenate(acc["rows"])
        return (order_rows, np.concatenate(acc["cand"]),
                np.concatenate(acc["votes"]), acc["hits"], acc["distinct"])

    # ---------------- pair scoring ----------------

    def _dev_store(self, store: SketchStore, quantum: int = 1024):
        """Scorer-ready device columns, row-padded to a size quantum
        (bounds jit variants); cached on the store.  Always keeps >= 1
        pad row (ordered_m = 0): lane padding in the score dispatches
        targets the last row so padded lanes exit the scorer immediately
        instead of scoring a real self-pair (which, in the while-loop
        exact scorer, runs the automaton over a full-overlap pair and
        dominates the dispatch).

        Tuple layout: (ordered_h, ordered_p, ordered_m, num_kmers)."""
        N = len(store)
        N_pad = (N // quantum + 1) * quantum
        cached = store._dev_cache
        if cached is not None and cached[0] == N_pad:
            return cached[1]

        pad_vals = dict(ordered_h=int(_kscorer.PAD_HASH),
                        ordered_p=0x7FFFFFFF, ordered_m=0, num_kmers=0)
        cols = []
        for name in ("ordered_h", "ordered_p", "ordered_m", "num_kmers"):
            a = store.dev(name)
            pad = N_pad - a.shape[0]
            if pad:
                a = jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1),
                            constant_values=pad_vals[name])
            cols.append(a)
        dev = tuple(cols)
        store._dev_cache = (N_pad, dev)
        return dev

    def _pull_rows(self, store: SketchStore, rows: np.ndarray):
        """Materialize a few sketch rows to host (slow-lane fallback):
        one packed transfer."""
        oh, op, om, nk = self._dev_store(store)[:4]
        r = jnp.asarray(rows.astype(np.int32))
        packed = np.asarray(jnp.concatenate(
            [oh[r], op[r], om[r][:, None], nk[r][:, None]], axis=1))
        S = (packed.shape[1] - 2) // 2
        return (packed[:, :S], packed[:, S:2 * S], packed[:, 2 * S],
                packed[:, 2 * S + 1])

    # max scorer lanes per dispatch: bounds the [lanes, 2S]-wide scan
    # intermediates (repeat-heavy datasets can produce hundreds of
    # thousands of candidate pairs)
    SCORE_DISPATCH_MAX = 16384

    SCORE_NAMES = ("ok", "inter", "k", "valid_cnt", "a1", "a2", "b1", "b2",
                   "needs_slow")

    # batches at least this large format through the native C formatter
    # (numeric-id runs only; header-carrying runs keep the Python path)
    NATIVE_FORMAT_MIN = 65536

    def _build_score_body(self):
        """Traceable gather+score body: the XLA fast pass
        (ops/scorer.make_score_pairs_fast).  Lanes it cannot reproduce
        bit-exactly flag needs_slow and re-score through the exact
        automaton (_rescore_slow) in a separate, run-batched dispatch:
        the automaton is a data-dependent while loop whose every
        iteration waits on a host round trip on the GPU, so it stays out
        of the primary program.
        Returns fn(q_dev, c_dev, qi, ci) -> dict of [T] arrays
        (SCORE_NAMES keys)."""
        fn = self._score_fast

        def body(q_dev, c_dev, qi, ci):
            qoh, qop, qom, qnk = q_dev[:4]
            coh, cop, com, cnk = c_dev[:4]
            return fn(qoh[qi], qop[qi], qom[qi], qnk[qi],
                      coh[ci], cop[ci], com[ci], cnk[ci])

        return body

    def _score_dispatch(self, qs, cs, qq, cc):
        """Gather+score on device, chunked to SCORE_DISPATCH_MAX lanes;
        outputs packed into a single array per chunk so each readback is
        one transfer (typical runs are a single dispatch)."""
        q_dev = self._dev_store(qs)
        c_dev = self._dev_store(cs) if cs is not qs else q_dev
        T = len(qq)
        P = self.pair_chunk
        names = self.SCORE_NAMES

        def run(qq_p, cc_p):
            key = (q_dev[0].shape[0], c_dev[0].shape[0], len(qq_p))
            gf = self._gather_score_cache.get(key)
            if gf is None:
                body = self._build_score_body()
                nq = len(q_dev)

                def impl(*args):
                    qd, cd = args[:nq], args[nq:-2]
                    qi, ci = args[-2:]
                    out = body(qd, cd, qi, ci)
                    return jnp.stack([out[k].astype(jnp.int32)
                                      for k in names])

                gf = jax.jit(impl)
                self._gather_score_cache[key] = gf
            return np.asarray(gf(*q_dev, *c_dev, jnp.asarray(qq_p),
                                 jnp.asarray(cc_p)))

        parts = []
        B = self.SCORE_DISPATCH_MAX
        for s in range(0, T, B):
            e = min(s + B, T)
            T_pad = max(P, ((e - s + P - 1) // P) * P)
            # padded lanes point at the guaranteed pad row (m = 0)
            qq_p = np.full(T_pad, q_dev[0].shape[0] - 1, np.int32)
            cc_p = np.full(T_pad, c_dev[0].shape[0] - 1, np.int32)
            qq_p[:e - s] = qq[s:e]
            cc_p[:e - s] = cc[s:e]
            parts.append(run(qq_p, cc_p)[:, :e - s])
        packed = np.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
        return {n: packed[i] for i, n in enumerate(names)}

    def _identity_scores(self, out: dict):
        """Integer scorer outputs -> (score, raw, edges) host arrays.

        The mash-identity conversion runs as scalar math.exp/log per
        DISTINCT (inter, k) pair: bit-identical to the oracle/Java double
        path (numpy's SIMD exp/log may differ by 1 ulp) at a few dozen
        scalar evaluations instead of one per lane."""
        k2 = self.cfg["ordered_kmer_size"]
        ok = out["ok"].astype(bool)
        kk = np.maximum(out["k"], 1)
        pair_key = out["inter"].astype(np.int64) * 4096 + kk
        uniq, inv = np.unique(pair_key, return_inverse=True)
        sc_u = np.array([_oscorer.jaccard_to_identity(
            float(u // 4096) / float(u % 4096), k2) for u in uniq])
        sc = sc_u[inv]
        score = np.where(ok, sc, 0.0)
        raw = np.where(ok, out["valid_cnt"].astype(np.float64), 0.0)
        T = len(score)
        edges = np.zeros((T, 4), np.int32)
        for n, name in enumerate(("a1", "a2", "b1", "b2")):
            edges[:, n] = np.where(ok, out[name], 0)
        return score, raw, edges

    def score_pairs(self, qs: SketchStore, cs: SketchStore,
                    qi: np.ndarray, ci: np.ndarray):
        """Batched stage-2 scoring of (qs[qi[t]], cs[ci[t]]) pairs.

        Two-phase dispatch: the vectorized fast pass scores every pair; the
        rare lanes it flags (duplicate-run/shift-retry corner cases, see
        ops/scorer._fast_pass) are re-scored with the exact sequential
        automaton, so the result set is bit-identical to the reference.

        Returns (score float64 [T], raw float64 [T], edges int32 [T, 4])."""
        T = len(qi)
        if T == 0:
            return (np.zeros(0, np.float64), np.zeros(0, np.float64),
                    np.zeros((0, 4), np.int32))
        out = self._score_dispatch(qs, cs, qi.astype(np.int32),
                                   ci.astype(np.int32))
        score, raw, edges = self._identity_scores(out)

        ns = out["needs_slow"].astype(bool)  # escalation-flagged lanes
        self.slow_pair_count += int(ns.sum())
        if ns.any():
            slow_t = np.nonzero(ns)[0]
            sc2, raw2, edges2 = self._rescore_slow(
                qs, cs, qi[slow_t].astype(np.int32),
                ci[slow_t].astype(np.int32))
            score[slow_t] = sc2
            raw[slow_t] = raw2
            edges[slow_t] = edges2
        return score, raw, edges

    # smallest exact-automaton dispatch; larger ones round up to a power
    # of two (at most SCORE_DISPATCH_MAX lanes), so a run compiles a
    # handful of variants however its flagged-lane counts vary
    SLOW_QUANTUM = 128

    def _rescore_slow(self, qs, cs, q_rows, c_rows):
        """Re-score flagged lanes with the EXACT merge automaton, on
        device (make_score_pairs: the lax.while_loop scorer at full record
        cap, fuzz-tested bit-identical to the oracle/C++).  Staying on
        device avoids pulling the flagged rows' [S] sketch columns to the
        host and running the Python automaton (~ms/pair on the host)."""
        q_dev = self._dev_store(qs)
        c_dev = self._dev_store(cs) if cs is not qs else q_dev
        T = len(q_rows)
        names = ("ok", "inter", "k", "valid_cnt", "a1", "a2", "b1", "b2")
        parts = []
        for s in range(0, T, self.SCORE_DISPATCH_MAX):
            e = min(s + self.SCORE_DISPATCH_MAX, T)
            T_pad = max(self.SLOW_QUANTUM, 1 << (e - s - 1).bit_length())
            # padded lanes point at the guaranteed pad row (m = 0): they
            # exit the while-loop automaton immediately
            qq_p = np.full(T_pad, q_dev[0].shape[0] - 1, np.int32)
            cc_p = np.full(T_pad, c_dev[0].shape[0] - 1, np.int32)
            qq_p[:e - s] = q_rows[s:e]
            cc_p[:e - s] = c_rows[s:e]
            key = ("exact", q_dev[0].shape[0], c_dev[0].shape[0], T_pad)
            gf = self._gather_score_cache.get(key)
            if gf is None:
                fn = _kscorer.make_score_pairs(
                    self.cfg["max_shift"], self.cfg["ordered_sketch_size"],
                    jit=False)

                def impl(qoh, qop, qom, qnk, coh, cop, com, cnk, q_i, c_i):
                    o = fn(qoh[q_i], qop[q_i], qom[q_i], qnk[q_i],
                           coh[c_i], cop[c_i], com[c_i], cnk[c_i])
                    return jnp.stack([o[k].astype(jnp.int32)
                                      for k in names])

                gf = jax.jit(impl)
                self._gather_score_cache[key] = gf
            parts.append(np.asarray(gf(*q_dev[:4], *c_dev[:4],
                                       jnp.asarray(qq_p),
                                       jnp.asarray(cc_p)))[:, :e - s])
        packed = np.concatenate(parts, axis=1)
        out = {n: packed[i] for i, n in enumerate(names)}
        k2 = self.cfg["ordered_kmer_size"]
        ok = out["ok"].astype(bool)
        kk = out["k"]
        with np.errstate(divide="ignore", invalid="ignore"):
            j = np.where(kk > 0, out["inter"] / np.maximum(kk, 1), 0.0)
        sc = np.array([_oscorer.jaccard_to_identity(float(x), k2)
                       for x in j])
        score = np.where(ok, sc, 0.0)
        raw = np.where(ok, out["valid_cnt"].astype(np.float64), 0.0)
        edges = np.zeros((T, 4), np.int32)
        for n_i, name in enumerate(("a1", "a2", "b1", "b2")):
            edges[:, n_i] = np.where(ok, out[name], 0)
        return score, raw, edges

    def _rescore_slow_host(self, qs, cs, q_rows, c_rows):
        """Host-oracle rescore (the sharded multi-process path keeps this:
        its row pulls ride a replicating jit and the CPU-mesh automaton
        compile is not worth paying for a handful of lanes)."""
        T = len(q_rows)
        k2 = self.cfg["ordered_kmer_size"]
        score = np.zeros(T, np.float64)
        raw = np.zeros(T, np.float64)
        edges = np.zeros((T, 4), np.int32)
        q_oh, q_op, q_om, q_nk = self._pull_rows(qs, q_rows)
        c_oh, c_op, c_om, c_nk = self._pull_rows(cs, c_rows)
        for t_i in range(T):
            m1 = int(q_om[t_i])
            m2 = int(c_om[t_i])
            s1 = np.stack([q_oh[t_i, :m1], q_op[t_i, :m1]], axis=1)
            s2 = np.stack([c_oh[t_i, :m2], c_op[t_i, :m2]], axis=1)
            sc1, rw, a1, a2, b1, b2 = _oscorer.get_overlap_info(
                s1, int(q_nk[t_i]), s2, int(c_nk[t_i]),
                k2, self.cfg["max_shift"])
            score[t_i] = sc1
            raw[t_i] = rw
            edges[t_i] = (a1, a2, b1, b2)
        return score, raw, edges

    # ---------------- match driving ----------------

    def _format(self, qs: SketchStore, cs: SketchStore, qi, ci, score, raw,
                edges) -> list[str]:
        """MatchResult coordinate flips + formatting (MatchResult.java).

        Coordinate flips and clamps run vectorized; only the final
        %-format runs per line."""
        T = len(qi)
        if T == 0:
            return []
        qi = np.asarray(qi, np.int64)
        ci = np.asarray(ci, np.int64)
        qlen = qs.length[qi].astype(np.int64)
        clen = cs.length[ci].astype(np.int64)
        qf = qs.is_fwd[qi]
        cf = cs.is_fwd[ci]
        a1, a2 = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
        b1, b2 = edges[:, 2].astype(np.int64), edges[:, 3].astype(np.int64)
        fa1 = np.where(qf, a1, qlen - a2 - 1)
        fa2 = np.where(qf, a2, qlen - a1 - 1)
        fb1 = np.where(cf, b1, clen - b2 - 1)
        fb2 = np.where(cf, b2, clen - b1 - 1)
        err = 1.0 - np.minimum(np.asarray(score, np.float64), 1.0)
        raw = np.asarray(raw, np.float64)
        qrc = np.where(qf, 0, 1)
        crc = np.where(cf, 0, 1)
        if (T >= self.NATIVE_FORMAT_MIN
                and not any(qs.headers) and not any(cs.headers)):
            # numeric display ids: the C bulk formatter (~0.1 us/line,
            # byte-identical output -- tests/test_format_native.py)
            from ..utils.native import format_m4

            return format_m4(qs.header_id[qi], cs.header_id[ci], err,
                             raw, qrc, fa1, fa2, qlen, crc, fb1, fb2,
                             clen)
        disp_q = [qs.display(int(q)) for q in qi]
        disp_c = [cs.display(int(c)) for c in ci]
        # zip over plain lists: per-element numpy scalar indexing costs
        # ~2x the whole %-format (measured 2.38 -> 1.12 us/line; the
        # repeat regime emits tens of millions of lines per run)
        return ["%s %s %.6f %.6f %d %d %d %d %d %d %d %d" % t
                for t in zip(disp_q, disp_c, err.tolist(), raw.tolist(),
                             qrc.tolist(), fa1.tolist(), fa2.tolist(),
                             qlen.tolist(), crc.tolist(), fb1.tolist(),
                             fb2.tolist(), clen.tolist())]

    @staticmethod
    @jax.jit
    def _gather_rows_jit(mh, rows):
        return mh[rows]

    def _dev_meta(self, store: SketchStore):
        """Device (header_id, length) int32 columns for on-device
        suppression; cached on the store."""
        m = getattr(store, "_dev_meta_cols", None)
        if m is None:
            hid = store.header_id
            if len(hid) and int(hid.max()) >= 2 ** 31:
                raise ValueError("header ids exceed int32 (device path)")
            m = (jnp.asarray(hid.astype(np.int32)),
                 jnp.asarray(store.length.astype(np.int32)))
            store._dev_meta_cols = m
        return m

    # pair-buffer compaction capacity of the fused vote dispatch; pairs
    # beyond it force a query-range split (never silently dropped).  The
    # buffer is device-resident and scored in SCORE_DISPATCH_MAX slices,
    # so the cap costs memory only -- size it for repeat-heavy runs
    # (hundreds of surviving pairs per query) to keep the split path
    # rare: the deepest split is 64 queries, and a 64-query range
    # overflowing 64k pairs falls back to the exact host route
    PAIR_CAP = 65536
    # score slices are padded to this quantum (bounds compile variants)
    # finer quantum = fewer wasted pad lanes per dispatch; the cold-gate
    # in _find_matches_device keeps the compile count at one variant per
    # distinct quantized size anyway
    SCORE_SLICE_QUANTUM = 512

    def _score_slice(self, q_dev, c_dev, rows_dev, pql, pc, base: int,
                     size: int):
        """One score dispatch over pairs [base, base+size) of the DEVICE
        pair buffer (from vote_suppress_compact; -1 entries are padding).
        Returns the packed [12, size] device array WITHOUT syncing -- the
        caller reads it back after checking the vote stats, so speculative
        dispatches on chunks that escalate are simply dropped."""
        key = ("slice", q_dev[0].shape[0], c_dev[0].shape[0], size)
        gf = self._gather_score_cache.get(key)
        if gf is None:
            body = self._build_score_body()
            names = self.SCORE_NAMES
            nq = len(q_dev)

            def impl(*args):
                qd, cd = args[:nq], args[nq:-4]
                q_rows, pql, pc, base = args[-4:]
                sub_ql = jax.lax.dynamic_slice(pql, (base,), (size,))
                sub_c = jax.lax.dynamic_slice(pc, (base,), (size,))
                realm = sub_ql >= 0
                Qn = q_rows.shape[0]
                qg = q_rows[jnp.clip(sub_ql, 0, Qn - 1)]
                qi = jnp.where(realm, qg, qd[0].shape[0] - 1)
                ci = jnp.where(realm, sub_c, cd[0].shape[0] - 1)
                out = body(qd, cd, qi, ci)
                return jnp.stack(
                    [out[k].astype(jnp.int32) for k in names]
                    + [sub_ql, sub_c])

            gf = jax.jit(impl)
            self._gather_score_cache[key] = gf
        return gf(*q_dev, *c_dev, rows_dev, pql, pc, self._dev_i32(base))

    def _dev_i32(self, v: int):
        """Device-resident i32 scalar, cached per value: a fresh
        jnp.int32(v) per dispatch costs a host->device upload every
        call; these are reused forever."""
        cache = getattr(self, "_i32_cache", None)
        if cache is None:
            cache = self._i32_cache = {}
        a = cache.get(v)
        if a is None:
            a = cache[v] = jax.device_put(np.int32(v))
        return a

    def _pull_combined(self, st, packs: list):
        """ONE readback for the vote stats block + the speculative score
        slices: flatten + concatenate on device, pull a single i32
        vector.  Each extra sync costs a full host round trip, so the
        per-chunk steady path pulls exactly once."""
        cache = getattr(self, "_pull_cache", None)
        if cache is None:
            cache = self._pull_cache = {}
        key = (st.shape, tuple(p.shape for p in packs))
        gf = cache.get(key)
        if gf is None:
            def impl(st, *ps):
                return jnp.concatenate(
                    [st.reshape(-1)] + [p.reshape(-1) for p in ps])

            gf = cache[key] = jax.jit(impl)
        flat = np.asarray(gf(st, *packs))
        n_st = int(np.prod(st.shape))
        out, off = [], n_st
        for p in packs:
            n = int(np.prod(p.shape))
            out.append(flat[off:off + n].reshape(p.shape))
            off += n
        return flat[:n_st].reshape(st.shape), out

    def _find_matches_device(self, index, queries: SketchStore,
                             q_sel: np.ndarray, to_self: bool) -> list[str]:
        """Fused device path: vote + suppression + pair compaction in one
        dispatch (index/postings.vote_suppress_compact), pairs handed to
        the scorer AS DEVICE ARRAYS (no [Q, 2K] vote readback, no pair
        re-push), score dispatched SPECULATIVELY before the vote stats
        sync (escalating chunks just drop the in-flight result).  Per
        steady chunk the host transfers: one small rows push, one [5, Q]
        stats readback, one packed score readback."""
        from ..index.postings import vote_suppress_compact

        kind, handle, store = index
        cfg = self.cfg
        mm = cfg["num_min_matches"]
        msl = int(cfg["min_store_length"])
        qmh_all = queries.dev("minhash")
        q_hid, q_len = self._dev_meta(queries)
        c_hid, c_len = self._dev_meta(store)
        q_dev = self._dev_store(queries)
        c_dev = self._dev_store(store) if store is not queries else q_dev
        N = len(store)
        lines: list[str] = []
        if not hasattr(self, "_vote_level"):
            self._vote_level = 0
        if not hasattr(self, "_score_hint"):
            self._score_hint = self.SCORE_SLICE_QUANTUM
        SQ = self.SCORE_SLICE_QUANTUM

        def host_range(s, e):
            postings = getattr(store, "_host_postings", None)
            if postings is None:
                postings = self.build_postings(store)
                store._host_postings = postings
            lines.extend(self._find_matches_host(
                ("host", postings, store), queries, q_sel[s:e], to_self))

        def score_ranges(upto):
            """Slice plan covering pairs [0, upto): one SQ-quantized
            dispatch (chunked at SCORE_DISPATCH_MAX).  Never split below
            the full quantized size -- each distinct size is a separate
            scorer compile, and hint-capped sub-slices used to compile a
            throwaway variant on every cold process."""
            plan = []
            b = 0
            while b < upto:
                size = min(self.SCORE_DISPATCH_MAX,
                           ((upto - b + SQ - 1) // SQ) * SQ)
                plan.append((b, size))
                b += size
            return plan

        def run_range(s, e, lvl):
            if lvl >= len(self.VOTE_LADDER):
                host_range(s, e)
                return
            span_cap, top_k = self.VOTE_LADDER[lvl]
            QC = max(64, min(self.VOTE_CHUNK,
                             (self.VOTE_CHUNK * 32) // span_cap))
            QC = min(QC, max(64, ((e - s + 255) // 256) * 256))
            K = min(top_k, N)
            for cs in range(s, e, QC):
                ce = min(cs + QC, e)
                t0 = time.perf_counter()
                rows = np.full(QC, -1, np.int32)
                rows[:ce - cs] = q_sel[cs:ce]
                rows_dev = jnp.asarray(rows)
                pql, pc, st = vote_suppress_compact(
                    handle[0], handle[1], qmh_all, rows_dev, q_hid, q_len,
                    c_hid, c_len, span_cap=span_cap, top_k=K,
                    min_matches=mm, msl=msl, to_self=bool(to_self),
                    p_cap=self.PAIR_CAP)
                # speculative score of the hint-sized head; its readback
                # rides the SAME pull as the vote stats (one host round
                # trip per steady chunk).  On a COLD process the head
                # size would compile a throwaway scorer variant -- skip
                # speculation until the variant exists and dispatch exact
                # sizes after the stats pull instead (one extra round
                # trip, once).
                head = [(b, sz)
                        for b, sz in score_ranges(min(self._score_hint,
                                                      self.PAIR_CAP))
                        if ("slice", q_dev[0].shape[0], c_dev[0].shape[0],
                            sz) in self._gather_score_cache]
                head_packs = [self._score_slice(q_dev, c_dev, rows_dev,
                                                pql, pc, b, sz)
                              for b, sz in head]
                sizes = dict(head)
                st_np, pulled = self._pull_combined(st, head_packs)
                packs = {b: p for (b, _), p in zip(head, pulled)}
                self.stats["minhash_search_time"] += (
                    time.perf_counter() - t0)
                nq = ce - cs
                if st_np[0, :nq].max(initial=0) > 0 or \
                        st_np[3, :nq].max(initial=0) > 0:
                    run_range(cs, ce, lvl + 1)  # in-flight scores dropped
                    continue
                self._vote_level = lvl
                cnt = int(st_np[4, 0])
                self.stats["elements_processed"] += int(st_np[1, :nq].sum())
                self.stats["sequences_hit"] += int(st_np[2, :nq].sum())
                if cnt > self.PAIR_CAP:
                    # compaction overflow: split the query range (recurse
                    # at the same ladder level), never drop pairs
                    if ce - cs >= 64:
                        h = (cs + ce) // 2
                        run_range(cs, h, lvl)
                        run_range(h, ce, lvl)
                    else:
                        host_range(cs, ce)
                    continue
                t0 = time.perf_counter()
                for b, sz in score_ranges(cnt):
                    if b not in packs or sizes[b] != sz:
                        packs[b] = self._score_slice(
                            q_dev, c_dev, rows_dev, pql, pc, b, sz)
                        sizes[b] = sz
                self._score_hint = min(
                    self.SCORE_DISPATCH_MAX,
                    max(SQ, ((cnt + SQ - 1) // SQ) * SQ))
                self.stats["sequences_fully_compared"] += cnt
                got = 0
                for b, sz in sorted(sizes.items()):
                    if got >= cnt:
                        break
                    packed = np.asarray(packs[b])
                    take = min(cnt - got, sz)
                    out = {n: packed[i, :take]
                           for i, n in enumerate(self.SCORE_NAMES)}
                    sub_ql = packed[len(self.SCORE_NAMES), :take]
                    sub_c = packed[len(self.SCORE_NAMES) + 1, :take]
                    got += take
                    score, raw, edges = self._identity_scores(out)
                    qg = rows[sub_ql]
                    ns = out["needs_slow"].astype(bool)
                    self.slow_pair_count += int(ns.sum())
                    if ns.any():
                        deferred.append((qg[ns].astype(np.int32),
                                         sub_c[ns].astype(np.int32)))
                    acc = (score >= cfg["threshold"]) & ~ns
                    self.stats["matches_processed"] += int(acc.sum())
                    lines.extend(self._format(
                        queries, store, qg[acc], sub_c[acc],
                        score[acc], raw[acc], edges[acc]))
                self.stats["sort_merge_time"] += time.perf_counter() - t0

        # flagged lanes of every chunk re-score in ONE end-of-run pass
        deferred: list = []
        run_range(0, len(q_sel), self._vote_level)
        lines.extend(self._rescore_deferred(queries, store, deferred))
        return lines

    # stores with at least this many rows route through the join-once
    # wide-store vote (index/joinvote.py); below it the per-chunk fused
    # path wins (its channel pack needs N < 2^16 anyway)
    WIDE_STORE_MIN = 0xFFFF

    def _find_matches(self, store: SketchStore, index, queries: SketchStore,
                      q_sel: np.ndarray, to_self: bool) -> list[str]:
        """Vote + suppression rules + scoring (MinHashSearch.java:149-251).

        Dispatches to the join-once wide-store path at reference scale,
        the fused device path otherwise; the host-postings path below is
        the exact fallback (CPU backend, ladder exhaustion, sharded
        subclass)."""
        if len(q_sel) == 0:
            return []
        store = index[2]  # candidate row ids refer to the index's store
        self.stats["sequences_searched"] += len(q_sel)
        if index[0] in ("dev", "shard"):
            if (len(store) >= self.WIDE_STORE_MIN
                    and self._wide_path_ok(store, queries, to_self)):
                # bound device memory by processing queries in slabs
                # (votes and suppression are per-query independent, so
                # slab partitioning is exact); the candidate buffer is
                # the big per-slab allocation: ~H*span*4 bytes per query.
                # Slabs are a pure recompute tax (stage A re-joins per
                # slab), so take ONE slab whenever the candidate buffer
                # fits the budget even at a span escalation (several
                # slabs re-pay stage A once each)
                from ..index import joinvote as JV

                H = self.cfg["num_hashes"]
                per_q = (H * JV.SPANS[0] + JV.E_RESID) * 4
                slab = self.WIDE_QUERY_SLAB
                if len(q_sel) * per_q * 2 <= self.WIDE_CAND_BUDGET:
                    slab = max(slab, len(q_sel))
                if len(q_sel) <= slab:
                    return self._find_matches_wide(index, queries, q_sel,
                                                   to_self)
                lines: list[str] = []
                for s in range(0, len(q_sel), slab):
                    part = np.asarray(q_sel[s:s + slab], np.int32)
                    if len(part) < slab:
                        # pad the trailing slab to the full slab shape:
                        # every slab then reuses ONE compiled program set
                        part = np.concatenate(
                            [part, np.full(slab - len(part), -1,
                                           np.int32)])
                    lines += self._find_matches_wide(
                        index, queries, part, to_self)
                return lines
            if index[0] == "dev":
                return self._find_matches_device(index, queries, q_sel,
                                                 to_self)
        return self._find_matches_host(index, queries, q_sel, to_self)

    # queries per wide-path slab: keeps the [slab, H*span] candidate
    # buffer ~0.7GB and the join width bounded at very large stores
    WIDE_QUERY_SLAB = 40960
    # single-slab budget: one slab is taken when the candidate buffer
    # (with 2x headroom for a span-16 escalation) fits this many bytes
    WIDE_CAND_BUDGET = 4 << 30

    def _wide_path_ok(self, store, queries, to_self) -> bool:
        """The wide path's row-compare suppression assumes default
        minStoreLength and header-ordered stores without padding rows
        (single-chip stores always are)."""
        return (int(self.cfg["min_store_length"]) == 0
                and store.n_real == len(store)
                and len(store) < (1 << 21))

    def _wide_hid(self, store):
        """Device header-id column for the wide vote's suppression, or
        None when the store is header-ordered without padding rows (the
        single-chip case: a pure row compare needs no gathers).  The
        sharded keep-in-place store overrides this."""
        return None

    def _find_matches_wide(self, index, queries: SketchStore,
                           q_sel: np.ndarray, to_self: bool) -> list[str]:
        """Join-once wide-store vote + single-sync scoring
        (index/joinvote.py).  Per run: stage A/B build the exact
        candidate buffer (no ladder, no speculative work), stage C
        chunks vote+suppress+compact into a device pair buffer, ONE
        stats sync sizes the fixed-shape score dispatches, and score
        readbacks stream back asynchronously while the device works."""
        from ..index import joinvote as JV

        kind, handle, store = index
        cfg = self.cfg
        mm = cfg["num_min_matches"]
        t0 = time.perf_counter()
        tp = time.perf_counter()
        # pad the query slab to a QC multiple with -1 slots BEFORE the
        # join: every slab of a run then shares one shape (one compile
        # set; the old trailing-slab shape compiled a full second set),
        # and the candidate buffer is born chunk-aligned (no 0.7GB pad
        # copy).  Padding slots join with a sentinel value (JoinedIndex)
        # and are masked out of the vote by q_valid.
        q_sel = np.asarray(q_sel, np.int32)
        # real wide runs (N >= 2^16 implies >= ~33k reads) always have
        # >= QC queries; the small-Q case only exists for the forced
        # WIDE_STORE_MIN tests, where a full-QC pad would inflate the
        # join ~50x -- chunk at a 256-quantum instead
        Qc = (JV.QC if len(q_sel) >= JV.QC
              else max(256, -(-len(q_sel) // 256) * 256))
        n_chunks = -(-len(q_sel) // Qc)
        Q = n_chunks * Qc
        if Q > len(q_sel):
            q_sel = np.concatenate(
                [q_sel, np.full(Q - len(q_sel), -1, np.int32)])
        ji = JV.JoinedIndex(handle[0], handle[1], queries.dev("minhash"),
                            q_sel)
        tp = _wp(f"stageA Q={Q} G={ji.G}", tp, ji.lr_hq)
        span, fb_idx = ji.plan_span()
        cand = ji.build_candidates(span)
        tp = _wp(f"stageB span={span}", tp, cand)
        cand, over_rows = ji.apply_residuals(cand, span)
        tp = _wp("residuals", tp, cand)
        fallback = set(int(i) for i in fb_idx)
        fallback.update(int(i) for i in over_rows)
        # queries ALREADY known to fall back (span plan + residual
        # overflow) are masked out of the vote entirely: their pairs
        # would be scored by the wide path and then discarded before
        # formatting, and re-scored by the direct path -- on
        # repeat-heavy data that double-pays a large share of the
        # scoring wall.  Only stage-C-discovered fallbacks (saturation,
        # chunk overflow) still flow through both.
        known_fb = np.zeros(Q, bool)
        if fallback:
            known_fb[np.fromiter(fallback, np.int64, len(fallback))] = True

        p_cap = 32 * Qc
        rows_pad = q_sel
        hid_dev = self._wide_hid(store)
        pairs_q, pairs_c, stats_parts = [], [], []
        for ci in range(n_chunks):
            sl = jax.lax.dynamic_slice_in_dim(cand, ci * Qc, Qc, axis=0)
            rows_dev = jnp.asarray(rows_pad[ci * Qc:(ci + 1) * Qc])
            valid = jnp.asarray(
                (rows_pad[ci * Qc:(ci + 1) * Qc] >= 0)
                & ~known_fb[ci * Qc:(ci + 1) * Qc])
            pq, pc, st = JV.vote_chunk(sl, rows_dev, valid, hid_dev, mm=mm,
                                       to_self=bool(to_self), p_cap=p_cap)
            pairs_q.append(pq)
            pairs_c.append(pc)
            stats_parts.append(st)
        tp = _wp(f"stageC n_chunks={n_chunks}", tp, *pairs_q)
        buf_q, buf_c, total = JV.compact_pairs(
            jnp.stack(pairs_q), jnp.stack(pairs_c),
            total_cap=n_chunks * p_cap)
        tp = _wp("compact", tp, buf_q)
        # 1.6GB+ at 100k reads; scoring no longer needs any of these
        del cand
        ji.q_t_full = None
        ji.lr_hq = None
        ji.joined = []
        store._dev_postings = None  # rebuilt next run
        st_all = jnp.concatenate(stats_parts, axis=1)  # [4, Q_pad]
        st_np, pulled = self._pull_combined(st_all, [total.reshape(1)])
        total = int(pulled[0][0])
        tp = _wp(f"stats-sync total={total}", tp)
        self.stats["minhash_search_time"] += time.perf_counter() - t0

        # escalation sets (known BEFORE stats so fallback queries are
        # counted exactly once, by the path that owns them)
        sat = np.nonzero(st_np[1, :Q])[0]
        fallback.update(int(i) for i in sat)
        # chunk pair-buffer overflow: all queries of that chunk re-run
        overflow_chunks = []
        for ci in range(n_chunks):
            if int(st_np[3, ci * Qc]) > p_cap:
                overflow_chunks.append(ci)
                fallback.update(range(ci * Qc, min((ci + 1) * Qc, Q)))
        fb = np.asarray([i for i in sorted(fallback)
                         if q_sel[i] >= 0], np.int64)
        # stats: fallback queries are re-voted by _find_matches_direct
        # (which reports its own hit mass / distinct counts), so their
        # wide-path contributions are excluded here -- the CLI final
        # stats would otherwise double-count them
        # (MinHashSearch.java:51-58 semantics)
        hits_q = np.asarray(ji.hits_q)
        self.stats["elements_processed"] += (int(hits_q[:Q].sum())
                                             - int(hits_q[fb].sum()))
        dist_q = st_np[0, :Q]
        self.stats["sequences_hit"] += (int(dist_q.sum())
                                        - int(dist_q[fb].sum()))
        # pairs of fallback queries flow through _score_wide but are
        # discarded by the fb_rows filter and re-scored by the direct
        # path; remove them from sequences_fully_compared as well
        ovfl = set(overflow_chunks)
        fb_pairs = sum(min(int(st_np[3, ci * Qc]), p_cap)
                       for ci in overflow_chunks)
        fb_pairs += sum(int(st_np[2, i]) for i in fb if i // Qc not in ovfl)

        t0 = time.perf_counter()
        lines = self._score_wide(queries, store, buf_q, buf_c, total,
                                 q_sel, fallback)
        self.stats["sequences_fully_compared"] -= fb_pairs
        self.stats["sort_merge_time"] += time.perf_counter() - t0
        tp = _wp("score+format", tp)

        if len(fb):
            lines += self._find_matches_direct(
                queries, store, q_sel[fb], to_self)
            tp = _wp(f"direct-fallback n={len(fb)}", tp)
        return lines

    def _find_matches_direct(self, queries, store, q_rows,
                             to_self) -> list[str]:
        """Exact uncapped device vote (index/joinvote.direct_vote) for
        the wide path's capacity-overflow queries.  The old host-postings
        fallback rebuilt the [H, N] host tables every run (~60s at 200k
        rows for a handful of monster queries); this is one streaming
        pass over the sketch matrix per 64-query batch."""
        from ..index import joinvote as JV

        mh_c = store.dev("minhash")
        mh_q = queries.dev("minhash")
        mm = self.cfg["num_min_matches"]
        hid_dev = self._wide_hid(store)
        lines: list[str] = []
        B = JV.DIRECT_NQ
        self.stats["direct_fallback_queries"] += len(q_rows)

        # Family-subset restriction (EXACT, opt-in): rows sharing no
        # band-aligned sketch value with any fallback query have zero
        # votes against all of them, so the dense vote only needs the
        # member rows (candidate_member_mask docstring).  On the earlier
        # target the vote was a small share of the direct stage, so
        # halving the candidate axis was a wash (the stage was
        # score/format-bound); not yet measured on the H100.  Kept
        # opt-in (ov.direct_subset = True) for stores where the vote
        # DOES dominate; exactness is pinned by tests/test_joinvote.py
        # either way.
        sub_mh = cand_dev = None
        n_sub = len(store)
        force = getattr(self, "direct_subset", None)
        # mm == 0 keeps zero-vote rows: the subset would be inexact
        if mm >= 1 and force:
            bp = max(256, 1 << int(len(q_rows) - 1).bit_length())
            rows_pad = np.full(bp, int(q_rows[0]), np.int32)
            rows_pad[:len(q_rows)] = q_rows
            q_vals = jnp.sort(mh_q[jnp.asarray(rows_pad)], axis=0)
            mask = np.asarray(JV.candidate_member_mask(mh_c, q_vals))
            sub = np.nonzero(mask)[0].astype(np.int32)
            if force or len(sub) <= JV.SUBSET_MAX_FRAC * len(mask):
                quantum = (JV.SUBSET_PAD
                           if jax.default_backend() == "gpu" else 256)
                n_sub = max(quantum, -(-len(sub) // quantum) * quantum)
                rows_sub = np.full(n_sub, -1, np.int32)
                rows_sub[:len(sub)] = sub
                cand_dev = jnp.asarray(rows_sub)
                sub_mh = jnp.take(mh_c, jnp.clip(cand_dev, 0,
                                                 mh_c.shape[0] - 1),
                                  axis=0)
                self.stats["direct_subset_rows"] = len(sub)

        def run_batch(batch):
            rows = np.full(B, -1, np.int32)
            rows[:len(batch)] = batch
            if sub_mh is not None:
                pq, pc, st = JV.direct_vote_subset(
                    sub_mh, cand_dev, mh_q, jnp.asarray(rows), hid_dev,
                    mm=mm, to_self=bool(to_self))
            else:
                pq, pc, st = JV.direct_vote(mh_c, mh_q, jnp.asarray(rows),
                                            hid_dev, mm=mm,
                                            to_self=bool(to_self))
            st_np = np.asarray(st)
            total = int(st_np[0])
            if total > min(JV.DIRECT_PAIR_CAP, B * n_sub):
                if len(batch) > 1:
                    # pair-buffer overflow: split the batch -- a SINGLE
                    # query's pairs are bounded by the store size, which
                    # is under the cap on any wide store this path
                    # serves, so the recursion always terminates before
                    # the old host-postings rebuild (~6GB of dicts and
                    # a minute of wall per run at 40k) becomes necessary
                    h = len(batch) // 2
                    run_batch(batch[:h])
                    run_batch(batch[h:])
                    return
                # single query beyond the cap (store > cap rows only):
                # exact host route, which reports its own stats
                postings = getattr(store, "_host_postings", None)
                if postings is None:
                    postings = self.build_postings(store)
                    store._host_postings = postings
                lines.extend(self._find_matches_host(
                    ("host", postings, store),
                    queries, batch.astype(np.int64), to_self))
                return
            self.stats["elements_processed"] += int(st_np[1])
            self.stats["sequences_hit"] += int(st_np[2])
            lines.extend(self._score_wide(queries, store, pq, pc, total,
                                          np.zeros(0, np.int32), set()))

        for s in range(0, len(q_rows), B):
            run_batch(np.asarray(q_rows[s:s + B], np.int32))
        return lines

    # fixed score-slice lane count (one compile).  Chosen on the earlier
    # target, where bigger slices halved per-slice host round trips; not
    # yet re-derived on the H100
    WIDE_SCORE_T = 32768

    def _wide_score_fn(self, n_q: int, n_c: int, can_pack: bool):
        """(jitted slice program, lane count T) of the wide scorer over
        scorer-padded stores of n_q / n_c rows.  The program scores pairs
        [base, base+T) of the device pair buffer and returns either the
        SCORE_NAMES rows + (q, c) or, when ``can_pack``, six packed words
        per lane (every edge fits 16 bits)."""
        # CPU (test) backend: a 32768-lane padded slice is minutes of
        # single-core work for a few hundred real pairs
        T = (self.WIDE_SCORE_T if jax.default_backend() == "gpu"
             else min(self.WIDE_SCORE_T, 4096))
        key = ("wide", can_pack, n_q, n_c, T)
        gf = self._gather_score_cache.get(key)
        if gf is None:
            body = self._build_score_body()
            names = self.SCORE_NAMES

            def impl(*args):
                qd, cd = args[:4], args[4:-3]
                pq, pc, base = args[-3:]
                sub_q = jax.lax.dynamic_slice(pq, (base,), (T,))
                sub_c = jax.lax.dynamic_slice(pc, (base,), (T,))
                realm = sub_q >= 0
                qi = jnp.where(realm, sub_q, qd[0].shape[0] - 1)
                ci = jnp.where(realm, sub_c, cd[0].shape[0] - 1)
                out = body(qd, cd, qi, ci)
                if not can_pack:
                    return jnp.stack(
                        [out[k].astype(jnp.int32) for k in names]
                        + [sub_q, sub_c])
                i32 = lambda k: out[k].astype(jnp.int32)
                w2 = (i32("inter") << 16) | i32("k")
                w3 = (i32("a1") << 16) | i32("a2")
                w4 = (i32("b1") << 16) | i32("b2")
                w5 = ((i32("valid_cnt") << 2) | (i32("ok") << 1)
                      | i32("needs_slow"))
                return jnp.stack([sub_q, sub_c, w2, w3, w4, w5])

            gf = jax.jit(impl)
            self._gather_score_cache[key] = gf
        return gf, T

    def _score_wide(self, queries, store, buf_q, buf_c, total: int,
                    q_sel, fallback: set) -> list[str]:
        """Score the device pair buffer in fixed-shape slices; async
        readbacks overlap the remaining dispatches."""
        if total == 0:
            return []
        q_dev = self._dev_store(queries)
        c_dev = self._dev_store(store) if store is not queries else q_dev
        names = self.SCORE_NAMES
        # 6-word packed readback when every edge fits 16 bits (reads
        # shorter than 65536 bases): 24 bytes per lane instead of 56
        can_pack = (int(queries.length.max(initial=0)) < 0xFFFF
                    and int(store.length.max(initial=0)) < 0xFFFF)
        gf, T = self._wide_score_fn(q_dev[0].shape[0], c_dev[0].shape[0],
                                    can_pack)
        # pad the buffer so every slice is in range
        n_slices = -(-total // T)
        need = n_slices * T
        if need > buf_q.shape[0]:
            pad = need - buf_q.shape[0]
            buf_q = jnp.pad(buf_q, ((0, pad),), constant_values=-1)
            buf_c = jnp.pad(buf_c, ((0, pad),), constant_values=-1)

        cfg = self.cfg
        lines: list[str] = []
        fb_rows = (np.asarray([int(q_sel[i]) for i in fallback
                               if q_sel[i] >= 0], np.int64)
                   if fallback else None)
        self.stats["sequences_fully_compared"] += total
        state = dict(got=0)

        def consume(p, take):
            packed = np.asarray(p)
            if can_pack:
                sub_q, sub_c = packed[0, :take], packed[1, :take]
                w2, w3, w4, w5 = (packed[i, :take] for i in range(2, 6))
                out = {
                    "inter": w2 >> 16, "k": w2 & 0xFFFF,
                    "a1": w3 >> 16, "a2": w3 & 0xFFFF,
                    "b1": w4 >> 16, "b2": w4 & 0xFFFF,
                    "valid_cnt": w5 >> 2, "ok": (w5 >> 1) & 1,
                    "needs_slow": w5 & 1,
                }
            else:
                out = {n: packed[i, :take] for i, n in enumerate(names)}
                sub_q = packed[len(names), :take]
                sub_c = packed[len(names) + 1, :take]
            score, raw, edges = self._identity_scores(out)
            ns = out["needs_slow"].astype(bool)
            self.slow_pair_count += int(ns.sum())
            if ns.any():
                # DEFER: escalated lanes batch into ONE end-of-run
                # rescore (a per-slice dispatch would stall the
                # dispatch/pull pipeline on a host round trip each time)
                deferred.append((sub_q[ns].astype(np.int32),
                                 sub_c[ns].astype(np.int32)))
            acc = (score >= cfg["threshold"]) & ~ns & (sub_q >= 0)
            if fb_rows is not None:
                acc &= ~np.isin(sub_q, fb_rows)
            self.stats["matches_processed"] += int(acc.sum())
            lines.extend(self._format(
                queries, store, sub_q[acc], sub_c[acc],
                score[acc], raw[acc], edges[acc]))

        # pipelined dispatch/pull/format: while the device scores slice
        # i, the host converts + formats slice i-1 (the device-to-host
        # copy of i-1 started right after its dispatch)
        deferred: list = []
        pending = None
        for si in range(n_slices):
            p = gf(*q_dev, *c_dev, buf_q, buf_c, self._dev_i32(si * T))
            p.copy_to_host_async()
            if pending is not None:
                take = min(T, total - state["got"])
                consume(pending, take)
                state["got"] += take
            pending = p
        if pending is not None:
            consume(pending, min(T, total - state["got"]))
        lines.extend(self._rescore_deferred(queries, store, deferred,
                                            fb_rows))
        return lines

    def _rescore_deferred(self, queries, store, deferred: list,
                          exclude_q=None) -> list[str]:
        """Exact-automaton rescore of the fast pass's flagged lanes,
        batched over a whole run: ``deferred`` holds (query rows,
        candidate rows) arrays.  Accepted pairs are formatted, except
        those whose query row is in ``exclude_q``."""
        if not deferred:
            return []
        dq = np.concatenate([d[0] for d in deferred])
        dc = np.concatenate([d[1] for d in deferred])
        sc2, raw2, edges2 = self._rescore_slow(queries, store, dq, dc)
        acc = sc2 >= self.cfg["threshold"]
        if exclude_q is not None:
            acc &= ~np.isin(dq, exclude_q)
        self.stats["matches_processed"] += int(acc.sum())
        return self._format(queries, store, dq[acc], dc[acc], sc2[acc],
                            raw2[acc], edges2[acc])

    def _find_matches_host(self, index, queries: SketchStore,
                           q_sel: np.ndarray, to_self: bool) -> list[str]:
        """Host-routed vote + suppression + scoring."""
        cfg = self.cfg
        store = index[2]
        t0 = time.perf_counter()
        q_idx, cand, votes, hits_total, distinct = self._vote_dispatch(
            index, queries, q_sel)
        self.stats["minhash_search_time"] += time.perf_counter() - t0
        self.stats["elements_processed"] += hits_total
        self.stats["sequences_hit"] += distinct
        if len(q_idx) == 0:
            return []
        t0 = time.perf_counter()
        qg = q_sel[q_idx]  # global query row in `queries`
        keepm = votes >= cfg["num_min_matches"]
        # header_id 0 marks padding/dropped rows (sharded keep-in-place
        # stores); real rows always have hid >= 1
        keepm &= store.header_id[cand] > 0
        msl = cfg["min_store_length"]
        q_hid = queries.header_id[qg]
        c_hid = store.header_id[cand]
        q_len = queries.length[qg].astype(np.int64)
        c_len = store.length[cand].astype(np.int64)
        if to_self:
            keepm &= c_hid != q_hid
        keepm &= ~((c_len < msl) & (q_len < msl))
        if to_self:
            keepm &= ~((c_hid > q_hid) & (c_len >= msl) & (q_len >= msl))
            keepm &= ~((c_len < msl) & (q_len >= msl))
        qg, cand = qg[keepm], cand[keepm]
        if len(qg) == 0:
            return []
        self.stats["sequences_fully_compared"] += len(qg)
        score, raw, edges = self.score_pairs(queries, store, qg, cand)
        acc = score >= cfg["threshold"]
        self.stats["matches_processed"] += int(acc.sum())
        lines = self._format(queries, store, qg[acc], cand[acc],
                             score[acc], raw[acc], edges[acc])
        self.stats["sort_merge_time"] += time.perf_counter() - t0
        return lines

    def _check_pending(self, store: SketchStore):
        """Verify a deferred-flags store: the async flags copy has long
        completed by the time results are pulled, so this is free on the
        happy path.  Raises OptimisticSketchMiss when the optimistic
        assumptions (no zero-ngram rows, no weight escalation) failed."""
        pending = getattr(store, "_pending_flags", None)
        if pending is None:
            return
        flags_dev, real_mask, esc_thresh = pending
        flags = np.asarray(flags_dev)
        store._pending_flags = None
        nv, mw = flags[0], flags[1]
        if (nv[real_mask] <= 0).any() or \
                (mw[real_mask] > esc_thresh).any():
            raise OptimisticSketchMiss

    def overlap_self(self, reads: list[str], headers=None) -> list[str]:
        """Self-overlap run; returns the sorted list of M4 lines."""
        defer = self._defer_flags
        for attempt in range(2):
            store = self.sketch_reads(reads, headers, defer_flags=defer)
            try:
                index = self._build_index(store)
                q_sel = np.nonzero(store.is_fwd)[0]
                lines = self._find_matches(store, index, store, q_sel,
                                           True)
                self._check_pending(store)
                return sorted(lines)
            except OptimisticSketchMiss:
                # rare: zero-ngram reads or weight escalation; the
                # dataset will keep tripping it, so stay strict
                self._defer_flags = defer = False
        raise AssertionError("strict sketch cannot miss")

    def overlap_query(self, box_reads: list[str], query_reads: list[str],
                      no_self: bool = False) -> list[str]:
        """Box-vs-query run (MhapMain usage 1 with -q)."""
        defer = self._defer_flags
        for attempt in range(2):
            box = self.sketch_reads(box_reads, defer_flags=defer)
            try:
                index = self._build_index(box)
                lines = []
                if not no_self:
                    q_sel = np.nonzero(box.is_fwd)[0]
                    lines += self._find_matches(box, index, box, q_sel,
                                                True)
                n_box = box.n_real // 2
                queries = self.sketch_reads(query_reads, offset=n_box,
                                            do_rc=False,
                                            defer_flags=defer)
                q_sel = np.arange(len(queries))
                lines += self._find_matches(box, index, queries, q_sel,
                                            False)
                self._check_pending(box)
                self._check_pending(queries)
                return sorted(lines)
            except OptimisticSketchMiss:
                self._defer_flags = defer = False
        raise AssertionError("strict sketch cannot miss")

