"""Sketch checkpoint stores.

1. Reference-compatible ``.dat`` binary format (the reference's
   checkpoint/resume system, SURVEY.md section 5):
   record = [u8 isFwd][i32be byteLen][payload], payload (big-endian, Java
   DataOutputStream) = u8 isFwd, i64 headerId, UTF header (u16 len +
   modified-UTF8), i32 seqLen, MinHash(i32 n + n*i32)
   (MinHashSketch.java:218-230), Bottom(i32 seqLen, i32 kmerSize, i32 m +
   m*(i32 hash, i32 pos)) (BottomOverlapSketch.java:561-585).  Framing:
   SequenceSketchStreamer.writeToBinary:322-395 / readFromBinary:278-320;
   payload: SequenceSketch.getAsByteArray:123-148.

2. Native columnar ``.npz`` sharded store (device-side fast path): dense
   arrays, one file per shard, zero parse cost on load.
"""

from __future__ import annotations

import struct

import numpy as np

from ..pipeline.overlapper import SketchStore


def _write_utf(s: str) -> bytes:
    b = s.encode("utf-8")  # ASCII headers: modified-UTF8 == UTF-8
    if len(b) > 0xFFFF:
        raise ValueError("header too long for Java writeUTF")
    return struct.pack(">H", len(b)) + b


def write_dat(path: str, store: SketchStore, fwd_only: bool = False,
              ordered_kmer_size: int = 12) -> None:
    with open(path, "wb") as f:
        for i in range(len(store)):
            fwd = bool(store.is_fwd[i])
            if fwd_only and not fwd:
                continue
            hid = int(store.header_id[i])
            if hid == 0:  # keep-in-place padding row (sharded stores)
                continue
            header = store.headers[i]
            if header is None:
                header = str(hid)
            mh = store.minhash[i]
            m = int(store.ordered_m[i])
            oh = store.ordered_h[i, :m]
            op = store.ordered_p[i, :m]
            payload = bytearray()
            payload += struct.pack(">B", 1 if fwd else 0)
            payload += struct.pack(">q", hid)
            payload += _write_utf(header)
            payload += struct.pack(">i", int(store.length[i]))
            payload += struct.pack(">i", len(mh))
            payload += mh.astype(">i4").tobytes()
            payload += struct.pack(">iii", int(store.num_kmers[i]),
                                   ordered_kmer_size, m)
            inter = np.empty((m, 2), dtype=">i4")
            inter[:, 0] = oh
            inter[:, 1] = op
            payload += inter.tobytes()
            f.write(struct.pack(">Bi", 1 if fwd else 0, len(payload)))
            f.write(payload)


def read_dat(path: str, offset: int = 0, fwd_only: bool = False,
             sketch_size: int = 1536) -> SketchStore:
    """Load a ``.dat`` file into a dense SketchStore.

    sketch_size: pad/clip width for the ordered arrays (reads shorter than
    the sketch produce fewer entries; the dense store pads with sentinels).
    """
    from ..ops.scorer import PAD_HASH

    recs = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    n = len(data)
    while pos + 5 <= n:
        is_fwd_tag, blen = struct.unpack_from(">Bi", data, pos)
        pos += 5
        if pos + blen > n:
            break
        payload = memoryview(data)[pos:pos + blen]
        pos += blen
        if fwd_only and is_fwd_tag != 1:
            continue
        p = 0
        fwd = payload[p] != 0
        p += 1
        (hid,) = struct.unpack_from(">q", payload, p)
        p += 8
        (hl,) = struct.unpack_from(">H", payload, p)
        p += 2
        header = bytes(payload[p:p + hl]).decode("utf-8")
        p += hl
        seq_len, nmh = struct.unpack_from(">ii", payload, p)
        p += 8
        mh = np.frombuffer(payload, dtype=">i4", count=nmh, offset=p).astype(np.int32)
        p += 4 * nmh
        nk, k2, m = struct.unpack_from(">iii", payload, p)
        p += 12
        pairs = np.frombuffer(payload, dtype=">i4", count=2 * m,
                              offset=p).astype(np.int32).reshape(m, 2)
        recs.append((hid + offset, fwd, header, seq_len, mh, nk, pairs))

    N = len(recs)
    H = len(recs[0][4]) if N else 0
    S = sketch_size
    out = SketchStore(
        header_id=np.asarray([r[0] for r in recs], np.int64),
        is_fwd=np.asarray([r[1] for r in recs], bool),
        length=np.asarray([r[3] for r in recs], np.int32),
        minhash=np.stack([r[4] for r in recs]) if N else np.zeros((0, H), np.int32),
        ordered_h=np.full((N, S), int(PAD_HASH), np.int32),
        ordered_p=np.full((N, S), 0x7FFFFFFF, np.int32),
        ordered_m=np.zeros(N, np.int32),
        num_kmers=np.asarray([r[5] for r in recs], np.int32),
        headers=[r[2] for r in recs],
    )
    for i, r in enumerate(recs):
        pairs = r[6][:S]
        out.ordered_h[i, :len(pairs)] = pairs[:, 0]
        out.ordered_p[i, :len(pairs)] = pairs[:, 1]
        out.ordered_m[i] = len(pairs)
    return out


def write_npz(path: str, store: SketchStore) -> None:
    """Native columnar store: one compressed npz per shard."""
    np.savez_compressed(
        path,
        header_id=store.header_id, is_fwd=store.is_fwd, length=store.length,
        minhash=store.minhash, ordered_h=store.ordered_h,
        ordered_p=store.ordered_p, ordered_m=store.ordered_m,
        num_kmers=store.num_kmers,
        headers=np.asarray([h if h is not None else "" for h in store.headers]),
        has_header=np.asarray([h is not None for h in store.headers]),
    )


def read_npz(path: str) -> SketchStore:
    z = np.load(path, allow_pickle=False)
    headers = [str(h) if b else None
               for h, b in zip(z["headers"], z["has_header"])]
    return SketchStore(
        header_id=z["header_id"], is_fwd=z["is_fwd"], length=z["length"],
        minhash=z["minhash"], ordered_h=z["ordered_h"],
        ordered_p=z["ordered_p"], ordered_m=z["ordered_m"],
        num_kmers=z["num_kmers"], headers=headers)
