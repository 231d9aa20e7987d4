"""Multi-host execution: two jax.distributed processes (TCP localhost),
4 virtual CPU devices each, forming one 8-device mesh; the sharded
overlapper must produce the same M4 line set as a single process
(SURVEY.md section 2.8 DCN mapping)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address={coord!r},
                           num_processes=2, process_id={pid})
import numpy as np
from mhap_tpu.parallel.sharded import ShardedOverlapper, make_mesh

rng = np.random.default_rng(77)
bases = np.frombuffer(b"ACGT", dtype=np.uint8)
genome = rng.choice(bases, 4000)
reads = [bytes(genome[(i * 97) % 2000:(i * 97) % 2000 + 1500]).decode()
         for i in range(12)]
cfg = dict(num_hashes=64, ordered_sketch_size=256, num_min_matches=2)
mesh = make_mesh(jax.devices())
assert mesh.devices.size == 8, mesh.devices
ov = ShardedOverlapper(mesh, cfg)
lines = ov.overlap_self(reads)
for l in lines:
    print("LINE\t" + l)
print("DONE", len(lines))
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_equals_single():
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = {**os.environ,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         _WORKER.format(repo=REPO, coord=coord, pid=pid)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-4000:]
        outs.append(out)

    def lines_of(out):
        return sorted(l.split("\t", 1)[1] for l in out.splitlines()
                      if l.startswith("LINE\t"))

    got0, got1 = lines_of(outs[0]), lines_of(outs[1])
    assert got0 == got1, "processes disagree"
    assert len(got0) > 0

    # single-process reference on the identical read set
    import jax

    from mhap_tpu.parallel.sharded import ShardedOverlapper, make_mesh

    rng = np.random.default_rng(77)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.choice(bases, 4000)
    reads = [bytes(genome[(i * 97) % 2000:(i * 97) % 2000 + 1500]).decode()
             for i in range(12)]
    cfg = dict(num_hashes=64, ordered_sketch_size=256, num_min_matches=2)
    ov = ShardedOverlapper(make_mesh(jax.devices()[:8]), cfg)
    want = ov.overlap_self(reads)
    assert got0 == want
