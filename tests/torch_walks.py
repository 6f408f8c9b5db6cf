"""Next-hop rows of rho-shaped walks for the walk-length tests: tails into
cycles with chosen mu + lambda, made with numpy. Used by the CPU tests of
the plain version against the JAX package (tests/test_torch_streamline.py)
and the cuda tests of K14 (tests/test_torch_kernels.py)."""

from __future__ import annotations

import numpy as np


def rho_row(totals, lams) -> np.ndarray:
    """A frame's next-hop row (int32) of rho-shaped components: for each
    total mu + lambda in `totals` and each cycle length lambda in `lams`
    (those up to the total), a tail of mu vertices into a cycle of lambda.
    The walks from its vertices have every mu from 0 to the component's."""
    nxt = []
    for total in totals:
        for lam in lams:
            if not 1 <= lam <= total:
                continue
            base, mu = len(nxt), total - lam
            nxt += [base + k + 1 for k in range(mu)]
            nxt += [base + mu + (k + 1) % lam for k in range(lam)]
    return np.asarray(nxt, dtype=np.int32)


def around_the_cap(max_steps: int, seed: int = 0) -> np.ndarray:
    """Two frames (2, N) of rho-shaped walks whose mu + lambda is cap - 1,
    cap or cap + 1 (cap = max_steps + 1); the second frame is the first with
    its vertices relabeled at random."""
    cap = max_steps + 1
    row = rho_row((cap - 1, cap, cap + 1),
                  (1, 2, 3, max(cap // 2, 1), cap - 1, cap, cap + 1))
    perm = np.random.default_rng(seed).permutation(row.size).astype(np.int32)
    relabeled = np.empty_like(row)
    relabeled[perm] = perm[row]
    return np.stack([row, relabeled])
