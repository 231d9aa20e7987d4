"""The GPU entry points on the CPU: the smoke script and the benchmark
refuse to run without a GPU, the smoke script's parity phases work at a
tiny size, and the persistent compile cache lands where it should."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from mhap_tpu.utils import compile_cache  # noqa: E402

CFG = dict(num_hashes=64, ordered_sketch_size=128)


def _run(args, cwd, **env):
    full = {**os.environ, "JAX_PLATFORMS": "cpu", **env}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """No GPU, or no repository around the script: non-zero exit and no
    result line on stdout."""
    if where == "checkout":
        script, cwd = os.path.join(REPO, "chip_smoke.py"), REPO
    else:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
        cwd = str(tmp_path)
    p = _run([script], cwd)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    if where == "checkout":
        assert "no GPU found" in p.stderr


def test_bench_fails_without_gpu():
    p = _run([os.path.join(REPO, "bench.py")], REPO)
    assert p.returncode != 0
    assert "no GPU found" in p.stderr
    assert p.stdout.strip() == ""


def test_compile_cache_dir_unset():
    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.compile_cache_dir({}) == want
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_dir_set(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the compiled program is written
    there and the checkout's own cache directory is left alone."""
    code = ("import jax, jax.numpy as jnp\n"
            "from mhap_tpu.utils.compile_cache import enable_compile_cache\n"
            "print(enable_compile_cache())\n"
            "jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()\n")
    own = os.path.join(REPO, ".jax_cache")
    before = sorted(os.listdir(own)) if os.path.isdir(own) else None
    p = _run(["-c", code], REPO, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == str(tmp_path)
    assert os.listdir(tmp_path)
    after = sorted(os.listdir(own)) if os.path.isdir(own) else None
    assert after == before


@pytest.mark.parametrize("w_max", [1, 8])
def test_min_reduce_matches_oracle(w_max):
    """The XLA min-reduce at the production width of 512 hashes against
    the numpy oracle: base rung (w_max 1, duplicates left active) and a
    weighted cap with weights up to 8."""
    reads = chip_smoke.repeat_reads(4, 3400, max(w_max, 4), seed=w_max)
    chip_smoke.minreduce_parity(reads, w_max, num_hashes=512, n_check=4)


def test_smoke_parity_phases_tiny():
    """chip_smoke's scorer and pair-structure phases at a tiny size."""
    import bench
    from mhap_tpu.pipeline.overlapper import TpuOverlapper

    reads, placements, _ = bench.make_reads_placed(24, seed=3)
    ov = TpuOverlapper(CFG)
    store = ov.sketch_reads(reads)
    qi, ci = chip_smoke.sample_pairs(store, placements, 64, seed=1)
    assert (qi == ci).any() and (qi != ci).any()
    chip_smoke.scorer_parity(ov, store, qi, ci)
    chip_smoke.structure_parity(ov, store, qi, ci)


def test_score_chain_flagged_lanes_match_oracle():
    """The score body TpuOverlapper builds is the XLA fast pass on every
    platform; the lanes it flags go to the exact automaton.  Tandem-repeat
    reads make long duplicate-hash runs, so some lanes are flagged, and
    every lane -- flagged or not -- must equal the oracle."""
    from mhap_tpu.oracle.scorer import get_overlap_info
    from mhap_tpu.pipeline.overlapper import TpuOverlapper

    rng = np.random.default_rng(9)
    bases = np.array(list("ACGT"))
    genome = "".join(rng.choice(bases, 6000))
    unit = "".join(rng.choice(bases, 40))
    reads = [genome[i:i + 2000] for i in range(0, 4000, 500)]
    reads += [(unit * 60)[i:i + 2000] for i in (0, 7, 13)]
    ov = TpuOverlapper(dict(CFG, ordered_sketch_size=256))
    store = ov.sketch_reads(reads)
    n = len(store.header_id)
    qi, ci = (a.ravel().astype(np.int32)
              for a in np.meshgrid(np.arange(n), np.arange(n)))
    flags = ov._score_dispatch(store, store, qi, ci)["needs_slow"]
    assert 0 < flags.sum() < len(qi)
    score, raw, edges = ov.score_pairs(store, store, qi, ci)
    assert ov.slow_pair_count == flags.sum()
    oh, op = store.ordered_h, store.ordered_p
    om, nk = store.ordered_m, store.num_kmers
    for t, (q, c) in enumerate(zip(qi, ci)):
        s1 = np.stack([oh[q, :om[q]], op[q, :om[q]]], axis=1)
        s2 = np.stack([oh[c, :om[c]], op[c, :om[c]]], axis=1)
        want = get_overlap_info(s1, int(nk[q]), s2, int(nk[c]), 12, 0.2)
        got = (score[t], raw[t], *(int(e) for e in edges[t]))
        assert got == want, (t, bool(flags[t]), got, want)
