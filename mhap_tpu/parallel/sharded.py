"""Multi-chip SPMD overlapper (mesh + shard_map + XLA collectives).

The reference is a single-JVM thread-pool program (SURVEY.md section 2.8);
this module re-expresses its three concurrency structures as SPMD over a
``jax.sharding.Mesh``, following the band-sharded postings design of
SURVEY.md section 2.8 / section 7:

  * data-parallel sketching  -> read batches row-sharded over the mesh,
    every device runs the fused sketch kernel on its shard
    (SequenceSketchStreamer.enqueueFullFile:179-222)
  * concurrent LSH index     -> band-sharded sorted postings: device d owns
    hash positions [d*H/D, (d+1)*H/D).  The index build is ONE all_to_all
    of the sketch matrix (each device receives all reads' values for its
    bands) plus a per-band lax.sort -- the postings analog of
    MinHashSearch's 512 hash tables (MinHashSearch.java:85-147).
  * work-stealing query loop -> chunked device-side vote: each band owner
    answers lookups for its bands with vectorized binary search
    (searchsorted) and routes the capped hit lists to the query's owner
    with a second all_to_all; the owner sort-merges votes and keeps the
    top-K candidates (MinHashSearch.java:161-225).  Fixed-capacity
    discipline with an escalation ladder: span_cap/top_k overflow re-runs
    the chunk at higher capacity and ultimately falls back to the exact
    host vote, so the result set is always exact.
  * candidate sketch fetch   -> masked-gather + psum: candidate rows live
    on their owning device; every device contributes its rows to a psum'd
    [T, C] gather (bounded by the pair chunk), then scores its T/D slice
    of the pair batch locally with the vectorized two-pass scorer.

Memory per device is O(N/D + N*H/D + chunk): no stage materializes an
all-pairs structure or a replicated sketch table, matching the reference's
ability to index 40K+ sequences (docs/source/quickstart.rst:23).

``ShardedOverlapper`` subclasses the single-chip ``TpuOverlapper`` so the
CLI surface, ``.dat`` round trips, suppression rules, host fallbacks, and
the M4 formatter are shared; only the dispatch layer changes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..ops import scorer as _kscorer
from ..pipeline.overlapper import (SketchStore, TpuOverlapper, _decode_2bit,
                                   _interleave_rc, _sketch_core)

I32 = jnp.int32


def make_mesh(devices=None, axis: str = "d") -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def _votes_from_sorted_hits(s, sentinel: int, min_matches: int, top_k: int):
    """Vote counting over per-query sorted candidate-id hit lists.

    s: [Q, M] int32 ascending, invalid entries == sentinel (sort last).
    Returns (cand [Q,K], votes [Q,K], distinct [Q]).
    """
    Q, M = s.shape
    new_run = jnp.concatenate(
        [jnp.ones((Q, 1), bool), s[:, 1:] != s[:, :-1]],
        axis=1) & (s < sentinel)
    pos = jnp.arange(M, dtype=I32)
    valid_total = jnp.sum(s < sentinel, axis=1, keepdims=True)
    run_start_idx = jnp.where(new_run, pos[None, :], M)
    nxt = jnp.concatenate(
        [run_start_idx[:, 1:], jnp.full((Q, 1), M, I32)], axis=1)
    d = 1
    while d < M:
        nxt = jnp.minimum(nxt, jnp.concatenate(
            [nxt[:, d:], jnp.full((Q, d), M, I32)], axis=1))
        d *= 2
    run_len = jnp.where(new_run,
                        jnp.minimum(nxt, valid_total) - pos[None, :], 0)
    run_len = jnp.maximum(run_len, 0)
    votes_all = jnp.where(new_run & (run_len >= min_matches), run_len, 0)
    top_votes, top_idx = jax.lax.top_k(votes_all, top_k)
    top_cand = jnp.take_along_axis(s, top_idx, axis=1)
    top_cand = jnp.where(top_votes > 0, top_cand, -1)
    distinct = jnp.sum(new_run, axis=1).astype(I32)
    return top_cand, top_votes, distinct


class ShardedOverlapper(TpuOverlapper):
    """Mesh-parallel overlapper: same semantics as TpuOverlapper, dispatch
    sharded over the mesh axis.

    The sketch store keeps chunk-padding rows IN PLACE (header_id 0) so no
    cross-device row compaction is ever needed; suppression filters them
    (pipeline/overlapper._find_matches: ``header_id > 0`` guard).
    """

    # filtered runs keep the host weighting flow under the mesh (the
    # shard_map sketch stages don't carry the filter tables yet)
    FILTER_DEVICE = False

    def __init__(self, mesh: Mesh, cfg=None, axis: str = "d", **kw):
        super().__init__(cfg, **kw)
        self.mesh = mesh
        self.axis = axis
        self.D = int(mesh.devices.size)
        self.ROWS = 256 * self.D
        self.device_vote = True
        # the sharded find path has its own stage structure; keep the
        # sketch flags sync strict (single-chip deferral only)
        self._defer_flags = False
        self.pair_chunk = max(self.pair_chunk,
                              ((self.pair_chunk + self.D - 1) // self.D)
                              * self.D)
        if self.cfg["num_hashes"] % self.D:
            raise ValueError(
                f"num_hashes={self.cfg['num_hashes']} must be divisible by "
                f"mesh size {self.D}")
        self._stages: dict = {}
        self._sharding = NamedSharding(mesh, P(axis))
        self._rep_sharding = NamedSharding(mesh, P())
        # multi-process (one controller per host): route readbacks through
        # a replicating jit and transfers through global-array constructors
        self._multiprocess = jax.process_count() > 1
        self._replicate = jax.jit(lambda a: a,
                                  out_shardings=self._rep_sharding)

    def _host_arr(self, x) -> np.ndarray:
        if self._multiprocess:
            x = self._replicate(x)
        return np.asarray(x)

    def _put_rep(self, x: np.ndarray):
        """Replicated global array from identical per-process host data."""
        return jax.device_put(x, self._rep_sharding)

    def _put_sharded(self, x: np.ndarray):
        """Row-shard identical per-process host data over the mesh."""
        if not self._multiprocess:
            return jax.device_put(x, self._sharding)
        from jax.experimental import multihost_utils

        n = x.shape[0]
        pc = jax.process_count()
        pid = jax.process_index()
        local = x[pid * n // pc:(pid + 1) * n // pc]
        return multihost_utils.host_local_array_to_global_array(
            local, self.mesh, P(self.axis))

    # ---------------- sketch dispatch ----------------

    def _push_bucket(self, packed, lens):
        # defer: chunks are device_put with row sharding per dispatch
        return (packed, lens)

    def _sketch_chunk(self, handle, s, cap, R):
        packed, lens = handle
        pk = self._put_sharded(packed[s:s + R])
        ln = self._put_sharded(lens[s:s + R])
        return self._sketch_stage(packed.shape[1], cap)(pk, ln)

    def _sketch_chunk_rc(self, handle, s, cap, R2):
        packed, lens = handle
        pk = self._put_sharded(packed[s:s + R2])
        ln = self._put_sharded(lens[s:s + R2])
        return self._sketch_stage_rc(packed.shape[1], cap)(pk, ln)

    def _sketch_minhash_codes(self, codes_list, cap):
        # single-device codes kernel unsupported under the mesh;
        # escalation falls back to chunk redo
        return None

    def _sketch_stage(self, L4: int, cap: int):
        key = ("sketch", L4, cap)
        fn = self._stages.get(key)
        if fn is None:
            cfg = self.cfg
            k1, k2 = cfg["kmer_size"], cfg["ordered_kmer_size"]
            H, S = cfg["num_hashes"], cfg["ordered_sketch_size"]

            @jax.jit
            @partial(jax.shard_map, mesh=self.mesh,
                     in_specs=(P(self.axis), P(self.axis)),
                     out_specs=P(self.axis), check_vma=False)
            def f(pk, ln):
                seq = _decode_2bit(pk, L4 * 4)
                return _sketch_core(seq, ln, k1, k2, H, S, cap)

            self._stages[key] = fn = f
        return fn

    def _sketch_stage_rc(self, L4: int, cap: int):
        """rc-paired sketch stage: each device interleaves its fwd block
        with device-derived rc strands (block row sharding keeps the
        global interleaved order)."""
        key = ("sketch_rc", L4, cap)
        fn = self._stages.get(key)
        if fn is None:
            cfg = self.cfg
            k1, k2 = cfg["kmer_size"], cfg["ordered_kmer_size"]
            H, S = cfg["num_hashes"], cfg["ordered_sketch_size"]

            @jax.jit
            @partial(jax.shard_map, mesh=self.mesh,
                     in_specs=(P(self.axis), P(self.axis)),
                     out_specs=P(self.axis), check_vma=False)
            def f(pk, ln):
                seq, lens2, start = _interleave_rc(pk, ln)
                return _sketch_core(seq, lens2, k1, k2, H, S, cap,
                                    start=start)

            self._stages[key] = fn = f
        return fn

    def _sketch_chunk_u8(self, sub, sl, cap):
        # irregular rows (non-ACGT): same stage without the 2-bit decode
        pk = self._put_sharded(sub)
        ln = self._put_sharded(sl)
        key = ("sketch_u8", sub.shape[1], cap)
        fn = self._stages.get(key)
        if fn is None:
            cfg = self.cfg
            k1, k2 = cfg["kmer_size"], cfg["ordered_kmer_size"]
            H, S = cfg["num_hashes"], cfg["ordered_sketch_size"]

            @jax.jit
            @partial(jax.shard_map, mesh=self.mesh,
                     in_specs=(P(self.axis), P(self.axis)),
                     out_specs=P(self.axis), check_vma=False)
            def f(pk, ln):
                return _sketch_core(pk, ln, k1, k2, H, S, cap)

            self._stages[key] = fn = f
        return fn(pk, ln)

    def _finalize_store(self, entries, do_rc, mh_valid, select_row):
        """Keep-in-place store: all chunk rows (including padding and
        zero-ngram-dropped rows) stay where they are, so no cross-device
        row compaction is needed; dropped/padding rows get header_id 0 and
        never query, candidate-match (``_find_matches`` hid>0 guard), or
        export (datstore skips hid 0)."""
        concat_fn = getattr(self, "_concat_fn", None)
        if concat_fn is None or self._long_rows:
            # long reads / empty runs: the compacted host store is correct
            # (the sharded stages re-push it with mesh sharding on entry)
            return super()._finalize_store(entries, do_rc, mh_valid,
                                           select_row)
        N = len(entries)
        keep = np.ones(N, bool)
        for j, (hid, fwd, hdr, codes) in enumerate(entries):
            if fwd and not mh_valid[j]:
                keep[j] = False
                if do_rc and j + 1 < N and entries[j + 1][0] == hid:
                    keep[j + 1] = False
            elif not fwd and not mh_valid[j]:
                keep[j] = False
        dev = concat_fn()
        T = int(dev["minhash"].shape[0])
        pos = self._entry_pos
        k2 = self.cfg["ordered_kmer_size"]
        hid = np.zeros(T, np.int64)
        fwd = np.zeros(T, bool)
        length = np.zeros(T, np.int32)
        headers: list = [None] * T
        for j in range(N):
            p = pos[j]
            if p < 0 or not keep[j]:
                continue
            hid[p] = entries[j][0]
            fwd[p] = entries[j][1]
            length[p] = len(entries[j][3])
            headers[p] = entries[j][2]
        nk = np.maximum(length.astype(np.int64) - k2 + 1, 0).astype(np.int32)
        dev["num_kmers"] = jnp.asarray(nk)
        return SketchStore(header_id=hid, is_fwd=fwd, length=length,
                           headers=headers, dev_cols=dev, num_kmers=nk)

    # ---------------- index + vote ----------------

    def _build_index(self, store: SketchStore):
        if store._dev_postings is None:
            N = len(store)
            if N % self.D:
                # pad rows to a mesh multiple (header_id 0 rows)
                store = _pad_store(store, self.D)
            fn = self._index_stage(len(store))
            hid32 = np.minimum(store.header_id,
                               np.iinfo(np.int32).max).astype(np.int32)
            vals, sids, mh_t = fn(store.dev("minhash"),
                                  self._put_sharded(hid32))
            store._dev_postings = (vals, sids, mh_t)
        return ("shard", store._dev_postings, store)

    def _index_stage(self, N: int):
        key = ("index", N)
        fn = self._stages.get(key)
        if fn is None:
            axis = self.axis

            @jax.jit
            @partial(jax.shard_map, mesh=self.mesh,
                     in_specs=(P(axis), P(axis)),
                     out_specs=(P(axis, None), P(axis, None),
                                P(None, axis)),
                     check_vma=False)
            def f(mh, hid):  # [b, H], [b] local rows
                # padding / dropped rows carry garbage sketch values;
                # pin them to the INT32_MAX sentinel so they cluster at
                # the end of every band's postings instead of polluting
                # real runs (the vote masks them by header id anyway)
                mh = jnp.where((hid > 0)[:, None], mh,
                               jnp.int32(0x7FFFFFFF))
                mh_t = jax.lax.all_to_all(mh, axis, split_axis=1,
                                          concat_axis=0, tiled=True)
                # mh_t: [B, Hl] -- all reads' values for my bands
                vals_t = mh_t.T  # [Hl, B]
                Hl, B = vals_t.shape
                sid = jnp.broadcast_to(jnp.arange(B, dtype=I32), (Hl, B))
                vals, sids = jax.lax.sort((vals_t, sid), dimension=1,
                                          num_keys=1)
                return vals, sids, mh_t

            self._stages[key] = fn = f
        return fn

    # ---------------- join-once wide vote under the mesh ----------------
    #
    # The single-chip wide driver (pipeline/overlapper._find_matches_wide)
    # runs UNCHANGED on the sharded backend: every joinvote stage is
    # data-parallel along either the band axis (stage A/B sorts and
    # cummaxes run along dim 1 of band-major arrays) or the query axis
    # (stage C), so GSPMD partitions the very same jitted programs across
    # the mesh from the band-sharded postings the index stage already
    # produces.  The only semantic difference is suppression: the
    # keep-in-place store is neither header-ordered nor padding-free, so
    # the vote gathers header ids (_wide_hid) instead of comparing row
    # numbers (joinvote.vote_chunk hid mode).

    def _wide_path_ok(self, store, queries, to_self) -> bool:
        # padding rows are fine here (hid suppression); multi-process
        # runs keep the chunked narrow path: the wide driver is a
        # single-controller loop with direct np.asarray pulls
        return (int(self.cfg["min_store_length"]) == 0
                and not self._multiprocess
                and len(store) < (1 << 21))

    def _wide_hid(self, store):
        h = getattr(store, "_hid_dev", None)
        if h is None:
            hid32 = np.minimum(store.header_id,
                               np.iinfo(np.int32).max).astype(np.int32)
            h = store._hid_dev = self._put_rep(hid32)
        return h

    VOTE_CHUNK = 2048

    def _vote_dispatch(self, index, queries, q_sel):
        kind, handle, store = index
        if kind != "shard":
            return super()._vote_dispatch(index, queries, q_sel)
        mm = self.cfg["num_min_matches"]
        N = len(store)
        self_mode = queries is store
        Q = len(q_sel)
        acc = dict(rows=[], cand=[], votes=[], hits=0, distinct=0)
        if not hasattr(self, "_vote_level"):
            self._vote_level = 0

        def host_fallback(s, e):
            if self._multiprocess:
                raise RuntimeError(
                    "vote capacity ladder exhausted in multi-process mode "
                    "(host fallback needs a single controller); raise "
                    "span_cap/top_k")
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
            if lvl >= len(self.VOTE_LADDER):
                host_fallback(s, e)
                return
            span_cap, top_k = self.VOTE_LADDER[lvl]
            QC = max(64, min(self.VOTE_CHUNK,
                             (self.VOTE_CHUNK * 32) // span_cap))
            QC = ((QC + self.D - 1) // self.D) * self.D
            K = min(top_k, N)
            fn = self._vote_stage(N, QC, span_cap, K, mm, self_mode)
            for cs in range(s, e, QC):
                ce = min(cs + QC, e)
                rows = np.zeros(QC, np.int32)
                rows[:ce - cs] = q_sel[cs:ce]
                if self_mode:
                    q_in = self._put_rep(rows)
                else:
                    q_in = self._gather_rows_jit(
                        queries.dev("minhash"), self._put_rep(rows))
                packed = self._host_arr(fn(*handle, q_in))[:ce - cs]
                cand = packed[:, :K]
                votes = packed[:, K:2 * K]
                overflow = packed[:, 2 * K]
                saturated = (K < N) & (votes[:, -1] > 0)
                if overflow.max() > 0 or np.any(saturated):
                    run_range(cs, ce, lvl + 1)
                    continue
                self._vote_level = lvl
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
        return (np.concatenate(acc["rows"]), np.concatenate(acc["cand"]),
                np.concatenate(acc["votes"]), acc["hits"], acc["distinct"])

    def _vote_stage(self, N, QC, span_cap, K, mm, self_mode):
        key = ("vote", N, QC, span_cap, K, mm, self_mode)
        fn = self._stages.get(key)
        if fn is None:
            axis = self.axis
            D = self.D

            @jax.jit
            @partial(jax.shard_map, mesh=self.mesh,
                     in_specs=(P(axis, None), P(axis, None), P(None, axis),
                               P()),
                     out_specs=P(axis), check_vma=False)
            def f(vals, sids, mh_t, q_in):
                # vals/sids: [Hl, N] postings for my bands;
                # mh_t: [N, Hl] band values; q_in: [QC] rows (self mode)
                #       or [QC, H] query minhash (query mode)
                Hl = vals.shape[0]
                if self_mode:
                    q_l = mh_t[q_in]                       # [QC, Hl]
                else:
                    d = jax.lax.axis_index(axis)
                    q_l = jax.lax.dynamic_slice(
                        q_in, (0, d * Hl), (QC, Hl))

                # same sort-join/channel expansion as the single-chip
                # kernel (index/postings.expand_hits) instead of vmapped
                # binary searches + computed gathers
                from ..index.postings import expand_hits

                cand, over_part, hits_part = expand_hits(
                    vals, sids, q_l, span_cap=span_cap)
                cand = jnp.where(cand >= vals.shape[1], N, cand)

                # route hits to the query owner
                hits2 = cand.reshape(QC, Hl * span_cap)
                mine = jax.lax.all_to_all(hits2, axis, split_axis=0,
                                          concat_axis=1, tiled=True)
                # [QC/D, H*cap]
                aux = jnp.stack([over_part, hits_part], axis=1)  # [QC, 2]
                aux_m = jax.lax.all_to_all(aux, axis, split_axis=0,
                                           concat_axis=1, tiled=True)
                aux_m = aux_m.reshape(QC // D, D, 2).sum(axis=1)

                s = jnp.sort(mine, axis=1)
                top_cand, top_votes, distinct = _votes_from_sorted_hits(
                    s, N, mm, K)
                return jnp.concatenate(
                    [top_cand.astype(I32), top_votes.astype(I32),
                     aux_m[:, :1].astype(I32), aux_m[:, 1:2].astype(I32),
                     distinct[:, None]], axis=1)

            self._stages[key] = fn = f
        return fn

    # ---------------- pair scoring ----------------

    def _score_dispatch(self, qs, cs, qq, cc):
        if len(qs) % self.D:
            qs = _pad_store(qs, self.D)
        if cs is not qs and len(cs) % self.D:
            cs = _pad_store(cs, self.D)
        T = len(qq)
        Pc = self.pair_chunk
        names = ("ok", "inter", "k", "valid_cnt", "a1", "a2", "b1", "b2",
                 "needs_slow")
        outs = []
        fn = self._score_stage(len(qs), len(cs), Pc,
                               same=(cs is qs))
        q_cols = tuple(qs.dev(n) for n in ("ordered_h", "ordered_p",
                                           "ordered_m", "num_kmers"))
        c_cols = q_cols if cs is qs else tuple(
            cs.dev(n) for n in ("ordered_h", "ordered_p", "ordered_m",
                                "num_kmers"))
        for s in range(0, T, Pc):
            e = min(s + Pc, T)
            qq_p = np.zeros(Pc, np.int32)
            cc_p = np.zeros(Pc, np.int32)
            qq_p[:e - s] = qq[s:e]
            cc_p[:e - s] = cc[s:e]
            packed = self._host_arr(fn(*q_cols, *c_cols,
                                       self._put_rep(qq_p),
                                       self._put_rep(cc_p)))[:, :e - s]
            outs.append(packed)
        packed = np.concatenate(outs, axis=1) if len(outs) > 1 else outs[0]
        # no in-program exact rescore here (the multi-process path keeps
        # the host-oracle fallback); every flagged lane is both counted
        # and re-scored by the caller
        return {n: packed[i] for i, n in enumerate(names)}

    def _score_stage(self, Nq, Nc, Pc, same):
        key = ("score", Nq, Nc, Pc, same)
        fn = self._stages.get(key)
        if fn is None:
            axis = self.axis
            D = self.D
            S = self.cfg["ordered_sketch_size"]
            score_fast = _kscorer.make_score_pairs_fast(
                self.cfg["max_shift"], S,
                cap=min(512, 2 * S), jit=False)

            @jax.jit
            @partial(jax.shard_map, mesh=self.mesh,
                     in_specs=(P(axis),) * 8 + (P(), P()),
                     out_specs=P(None, axis), check_vma=False)
            def f(qoh, qop, qom, qnk, coh, cop, com, cnk, qi, ci):
                d = jax.lax.axis_index(axis)

                def gather(oh, op, om, nk, rows):
                    b = oh.shape[0]
                    X = jnp.concatenate(
                        [oh, op, om[:, None], nk[:, None]],
                        axis=1).astype(I32)                  # [b, C]
                    owner = rows // b
                    loc = jnp.clip(rows % b, 0, b - 1)
                    m = owner == d
                    g = jnp.where(m[:, None], X[loc], 0)
                    return jax.lax.psum(g, axis)             # [T, C] repl

                Gq = gather(qoh, qop, qom, qnk, qi)
                Gc = gather(coh, cop, com, cnk, ci)
                t = qi.shape[0] // D
                myq = jax.lax.dynamic_slice(Gq, (d * t, 0),
                                            (t, Gq.shape[1]))
                myc = jax.lax.dynamic_slice(Gc, (d * t, 0),
                                            (t, Gc.shape[1]))

                def unpack(G):
                    return (G[:, :S], G[:, S:2 * S], G[:, 2 * S],
                            G[:, 2 * S + 1])

                a_h, a_p, a_m, a_nk = unpack(myq)
                b_h, b_p, b_m, b_nk = unpack(myc)
                out = score_fast(a_h, a_p, a_m, a_nk, b_h, b_p, b_m, b_nk)
                keys = ("ok", "inter", "k", "valid_cnt", "a1", "a2",
                        "b1", "b2", "needs_slow")
                return jnp.stack([out[k].astype(I32) for k in keys])

            self._stages[key] = fn = f
        return fn

    # flagged lanes: keep the host-oracle rescore (the sharded row pulls
    # ride the replicating gather stage; a CPU-mesh exact-automaton compile
    # is not worth a handful of lanes)
    _rescore_slow = TpuOverlapper._rescore_slow_host

    def _pull_rows(self, store: SketchStore, rows: np.ndarray):
        if len(store) % self.D:
            store = _pad_store(store, self.D)
        n = len(rows)
        n_pad = ((n + self.D - 1) // self.D) * self.D
        r = np.zeros(n_pad, np.int32)
        r[:n] = rows
        fn = self._gather_stage(len(store), n_pad)
        cols = tuple(store.dev(c) for c in ("ordered_h", "ordered_p",
                                            "ordered_m", "num_kmers"))
        packed = np.asarray(fn(*cols, self._put_rep(r)))[:n]
        S = (packed.shape[1] - 2) // 2
        return (packed[:, :S], packed[:, S:2 * S], packed[:, 2 * S],
                packed[:, 2 * S + 1])

    def _gather_stage(self, N, T):
        key = ("gather", N, T)
        fn = self._stages.get(key)
        if fn is None:
            axis = self.axis

            @jax.jit
            @partial(jax.shard_map, mesh=self.mesh,
                     in_specs=(P(axis),) * 4 + (P(),),
                     out_specs=P(), check_vma=False)
            def f(oh, op, om, nk, rows):
                d = jax.lax.axis_index(axis)
                b = oh.shape[0]
                X = jnp.concatenate(
                    [oh, op, om[:, None], nk[:, None]], axis=1).astype(I32)
                owner = rows // b
                loc = jnp.clip(rows % b, 0, b - 1)
                g = jnp.where((owner == d)[:, None], X[loc], 0)
                return jax.lax.psum(g, axis)

            self._stages[key] = fn = f
        return fn


def _pad_store(store: SketchStore, D: int) -> SketchStore:
    """Pad a store to a mesh-divisible row count with header_id-0 rows."""
    N = len(store)
    N_pad = ((N + D - 1) // D) * D
    if N_pad == N:
        return store
    pad = N_pad - N
    pad_vals = dict(minhash=0, ordered_h=int(_kscorer.PAD_HASH),
                    ordered_p=0x7FFFFFFF, ordered_m=0, num_kmers=0)

    dev = {}
    for name in SketchStore.COLS:
        a = store.dev(name)
        dev[name] = jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1),
                            constant_values=pad_vals[name])
    out = SketchStore(
        header_id=np.concatenate([store.header_id, np.zeros(pad, np.int64)]),
        is_fwd=np.concatenate([store.is_fwd, np.zeros(pad, bool)]),
        length=np.concatenate([store.length, np.zeros(pad, np.int32)]),
        headers=store.headers + [None] * pad,
        dev_cols=dev)
    return out


def self_overlap_sharded(mesh: Mesh, cfg: dict, reads: list[str], *,
                         top_k: int = 16, w_cap: int = 8) -> list[str]:
    """Run a sharded self-overlap and return the sorted M4 line set
    (parity wrapper used by tests and the bench)."""
    ov = ShardedOverlapper(mesh, cfg)
    return ov.overlap_self(reads)
