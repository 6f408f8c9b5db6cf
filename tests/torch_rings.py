"""Synthetic ring tables for the winding kernel's tests: rings of chosen
member counts around three centers, made with numpy from a seed. Used by
the CPU tests of the plain version (tests/test_torch_winding.py) and the
cuda tests of K15 (tests/test_torch_kernels.py)."""

from __future__ import annotations

import numpy as np
import torch

RING_SIZES = (0, 1, 2, 31, 32, 33, 300)


def synthetic_rings(device, dtype, levels, seed=0):
    """Ring tables (order, bounds, e1, e2) of three centers whose rings hold
    0, 1, 2, 31, 32, 33 and 300 members in turn (more than 2048 members a
    row at 40 rings), every member its own vertex in shuffled order, and a
    field v_world (3, N, 3): in frames 0 and 1 the directions turn once
    anticlockwise along every ring of center 0, once clockwise along those
    of center 1, at random around center 2, with noise and a normal part;
    frame 2 is all zero."""
    rng = np.random.default_rng(seed)
    rows, bounds = [], []
    for shift in (5, 3, 6):
        sizes = [RING_SIZES[(r + shift) % len(RING_SIZES)] for r in range(levels)]
        bounds.append(np.concatenate([[0], np.cumsum(sizes)]))
        rows.append(sizes)
    n = sum(int(b[-1]) for b in bounds) + 5
    ids = rng.permutation(n)
    basis = np.linalg.qr(rng.standard_normal((3, 3, 3)))[0]      # (U, 3, 3)
    v = np.zeros((3, n, 3))
    width = max(int(b[-1]) for b in bounds)
    order = np.zeros((3, width), dtype=np.int32)
    used = 0
    for c, (sizes, b) in enumerate(zip(rows, bounds)):
        row = ids[used:used + int(b[-1])]
        used += int(b[-1])
        order[c, :len(row)] = row
        for size, lo in zip(sizes, b[:-1]):
            j = np.arange(size)
            for f in range(2):
                turn = (1.0, -1.0)[c] if c < 2 else None
                theta = (2 * np.pi * turn * j / max(size, 1)
                         + 0.15 * rng.standard_normal(size) if turn is not None
                         else rng.uniform(0, 2 * np.pi, size))
                mag = 0.5 + rng.uniform(size=size)
                v[f, row[lo:lo + size]] = (
                    mag[:, None] * (np.cos(theta)[:, None] * basis[c, 0]
                                    + np.sin(theta)[:, None] * basis[c, 1])
                    + rng.uniform(-0.3, 0.3, (size, 1)) * basis[c, 2])

    def arr(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, dt)
    return (arr(v, dtype), arr(order, torch.int32), arr(np.stack(bounds), torch.int32),
            arr(basis[:, 0], dtype), arr(basis[:, 1], dtype))
