"""Test configuration: force an 8-device virtual CPU mesh.

Multi-device sharding behavior is tested on the CPU backend with
xla_force_host_platform_device_count (the standard JAX approach).  The GPU
path is exercised on the card by chip_smoke.py and bench.py.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax

jax.config.update("jax_platforms", "cpu")
# the CLI entry point turns the persistent compile cache on; tests that
# drive it in-process must not write one into the checkout
jax.config.update("jax_enable_compilation_cache", False)
assert jax.devices()[0].platform == "cpu"

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)


BASES = np.array(list("ACGT"))


def random_dna(rng, n: int) -> str:
    return "".join(rng.choice(BASES, n))


def noisy_read(rng, genome: str, pos: int, ln: int, err: float = 0.10) -> str:
    """PacBio-like error model (ins-heavy), cf. utils/RandomSequenceGenerator."""
    out = []
    for ch in genome[pos:pos + ln]:
        r = rng.random()
        if r < err * 0.4:
            out.append(ch)
            out.append(str(rng.choice(BASES)))
        elif r < err * 0.7:
            pass
        elif r < err:
            out.append(str(rng.choice(BASES)))
        else:
            out.append(ch)
    return "".join(out)


@pytest.fixture(scope="session")
def synthetic_reads(rng):
    """20 noisy 3kb reads tiling a 20kb genome (session-cached)."""
    genome = random_dna(rng, 20000)
    reads, positions = [], []
    for _ in range(20):
        pos = int(rng.integers(0, 15000))
        reads.append(noisy_read(rng, genome, pos, 3000))
        positions.append(pos)
    return genome, reads, positions
