"""Multi-device SPMD path: sharded self-overlap must equal the oracle and
be invariant across mesh shapes (SURVEY.md section 4 item 5)."""

import jax
import numpy as np
import pytest

from mhap_tpu.oracle import pipeline as op
from mhap_tpu.parallel import sharded

CFG = dict(op.DEFAULTS, num_hashes=64, ordered_sketch_size=256,
           num_min_matches=2)


@pytest.fixture(scope="module")
def small_reads(synthetic_reads):
    genome, reads, positions = synthetic_reads
    return [r[:1200] for r in reads[:10]]


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_sharded_equals_oracle(small_reads, ndev):
    mesh = sharded.make_mesh(jax.devices()[:ndev])
    got = sharded.self_overlap_sharded(mesh, CFG, small_reads, top_k=16)
    want = op.overlap_self(small_reads, CFG)
    assert got == want
    assert len(got) > 0


def test_mesh_shape_invariance(small_reads):
    m2 = sharded.make_mesh(jax.devices()[:2])
    m4 = sharded.make_mesh(jax.devices()[:4])
    got2 = sharded.self_overlap_sharded(m2, CFG, small_reads, top_k=16)
    got4 = sharded.self_overlap_sharded(m4, CFG, small_reads, top_k=16)
    assert got2 == got4


def test_sharded_midsize_capacity_parity():
    """A mid-size sharded run (600 reads, ~17x
    coverage) that actually reaches the capacity/escalation machinery
    (bucket pushes, vote ladder, pair compaction) which 10-read units
    cannot -- line-set equality vs the oracle on an 8-device mesh."""
    rng = np.random.default_rng(99)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    glen = 28_000
    genome = rng.integers(0, 4, glen + 1200)
    reads = []
    for _ in range(600):
        pos = int(rng.integers(0, glen))
        L = int(rng.integers(500, 1100))
        raw = genome[pos:pos + int(L * 1.15)]
        r = rng.random(len(raw))
        keep = r >= 0.03                  # deletions
        sub = (r >= 0.03) & (r < 0.06)    # substitutions
        out = np.where(sub, rng.integers(0, 4, len(raw)), raw)[keep][:L]
        reads.append(bytes(bases[out]).decode())
    mesh = sharded.make_mesh(jax.devices()[:8])
    got = sharded.self_overlap_sharded(mesh, CFG, reads, top_k=16)
    want = op.overlap_self(reads, CFG)
    assert got == want
    assert len(got) > 300  # deep coverage must produce real overlap mass


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_wide_path_parity(small_reads, ndev):
    """The join-once wide vote under the mesh (GSPMD-partitioned stage
    A/B/C with header-id suppression) must give the oracle line set;
    the spy pins that the wide driver actually ran."""
    reads = small_reads
    mesh = sharded.make_mesh(jax.devices()[:ndev])
    ov = sharded.ShardedOverlapper(mesh, CFG)
    ov.WIDE_STORE_MIN = 4  # force the wide route on the tiny store
    called = {}
    orig = ov._find_matches_wide

    def spy(*a, **k):
        called["wide"] = True
        return orig(*a, **k)

    ov._find_matches_wide = spy
    got = ov.overlap_self(reads)
    want = op.overlap_self(reads, CFG)
    assert called.get("wide")
    assert got == want


def test_sharded_wide_midsize_parity():
    """Mid-size wide-path run on an 8-device mesh: deep enough for real
    residual/fallback machinery; line-set equality vs the oracle."""
    rng = np.random.default_rng(123)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    glen = 20_000
    genome = rng.integers(0, 4, glen + 1200)
    reads = []
    for _ in range(400):
        pos = int(rng.integers(0, glen))
        L = int(rng.integers(500, 1100))
        raw = genome[pos:pos + int(L * 1.15)]
        r = rng.random(len(raw))
        keep = r >= 0.03
        sub = (r >= 0.03) & (r < 0.06)
        out = np.where(sub, rng.integers(0, 4, len(raw)), raw)[keep][:L]
        reads.append(bytes(bases[out]).decode())
    mesh = sharded.make_mesh(jax.devices()[:8])
    ov = sharded.ShardedOverlapper(mesh, CFG)
    ov.WIDE_STORE_MIN = 4
    got = ov.overlap_self(reads)
    want = op.overlap_self(reads, CFG)
    assert got == want
    assert len(got) > 150
