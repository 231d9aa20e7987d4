"""Decompose the direct-vote subset path's cost at probe shapes.

probe_direct_subset.py at 16k reads showed the subset restriction cuts
the candidate axis 2.0x but the direct stage time does not move --
something in the subset path costs as much as it saves.  This probe
times each piece in isolation on the chip (block_until_ready on the
small stats outputs; NOTES r3: never time via full-output pulls).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mhap_tpu.index import joinvote as JV  # noqa: E402


def t(label, fn, reps=3):
    # time by pulling a small reduction of the output to the host, not
    # the full output (whose device-to-host copy would dominate)
    np.asarray(jnp.sum(jnp.ravel(fn())[:4]))  # compile + settle
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(jnp.sum(jnp.ravel(fn())[:4]))
        times.append(time.perf_counter() - t0)
    print(f"{label}: {sorted(times)[len(times)//2]*1000:.0f}ms "
          f"(runs {[round(x*1000) for x in times]})", flush=True)


def main():
    rng = np.random.default_rng(1)
    N, H, B = 32768, 512, 512
    NS, BP = 16384, 8192
    mh = jnp.asarray(rng.integers(-2**31, 2**31 - 1, (N, H), dtype=np.int64)
                     .astype(np.int32))
    rows = jnp.asarray(rng.choice(N, B, replace=False).astype(np.int32))
    sub_rows = jnp.asarray(np.sort(rng.choice(N, NS, replace=False))
                           .astype(np.int32))
    qp = jnp.asarray(rng.choice(N, BP, replace=False).astype(np.int32))

    t("direct_vote      [512 x 32768 x 512]",
      lambda: JV.direct_vote(mh, mh, rows, None, mm=3, to_self=True)[2])
    sub_mh = jnp.take(mh, sub_rows, axis=0)
    jax.block_until_ready(sub_mh)
    t("direct_vote_subset [512 x 16384 x 512]",
      lambda: JV.direct_vote_subset(sub_mh, sub_rows, mh, rows, None,
                                    mm=3, to_self=True)[2])
    qv = jnp.sort(mh[qp], axis=0)
    jax.block_until_ready(qv)
    t("member_mask [N=32768, B=8192]",
      lambda: JV.candidate_member_mask(mh, qv))
    t("q_vals sort [8192 x 512]", lambda: jnp.sort(mh[qp], axis=0))
    t("sub gather [16384 x 512]",
      lambda: jnp.take(mh, jnp.clip(sub_rows, 0, N - 1), axis=0))


if __name__ == "__main__":
    main()
