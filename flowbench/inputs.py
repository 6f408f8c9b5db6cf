"""The benchmark's inputs: surfaces, electrode epochs and velocity movies.

Everything here is made by the benchmark from its configuration and the
run's seed, with numpy (or torch on the device for the bulk of the fields'
velocity movies), and handed alike to the port and to the reference. The
same seed gives the same inputs. A configuration's surface does not depend
on the seed, so every seed runs the same sizes.

A trial is two travelling waves from seeded sources, sampled at the 64
electrodes over the whole epoch with seeded noise: each source's frequency
and speed come from the traffic's fixed ranges by pool slot, and the seed
draws the sources' places and phases, the noise and the order of the slots.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from flowbench import s1_reconstruct


def _height(spec: dict):
    amp, sx, sy = spec["amp_mm"], spec["x_scale_mm"], spec["y_scale_mm"]
    return lambda x, y: amp * np.sin(x / sx) * np.cos(y / sy)


def plane_patch(spec: dict) -> tuple[np.ndarray, np.ndarray]:
    """The warped rectangular patch (bench.py's `_mesh_12k` recipe)."""
    nx, ny = spec["nx"], spec["ny"]
    gx, gy = np.meshgrid(np.linspace(0.0, spec["lx_mm"], nx),
                         np.linspace(0.0, spec["ly_mm"], ny), indexing="ij")
    gz = _height(spec["height"])(gx, gy)
    points = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=-1)
    idx = np.arange(nx * ny).reshape(nx, ny)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[:-1, 1:].ravel(), idx[1:, 1:].ravel()
    tris = np.concatenate([np.stack([a, b, d], -1), np.stack([a, d, c], -1)])
    return points, tris.astype(np.int32)


def grid_on_patch(spec: dict, surface: dict) -> np.ndarray:
    """An n x n electrode grid laid on the patch's surface."""
    n, m = spec["grid"], spec["margin_mm"]
    u, v = np.meshgrid(np.linspace(m, surface["lx_mm"] - m, n),
                       np.linspace(m, surface["ly_mm"] - m, n), indexing="ij")
    z = _height(surface["height"])(u, v)
    return np.stack([u.ravel(), v.ravel(), z.ravel()], axis=-1)


def curved_grid(spec: dict) -> np.ndarray:
    """An n x n clinical grid laid on a gently curved sheet, with jitter
    from the configuration's own seed: the layout S1 reconstructs."""
    rng = np.random.default_rng(spec["seed"])
    n, pitch = spec["grid"], spec["pitch_mm"]
    (cx, cy), (kx, ky) = spec["center_mm"], spec["curvature_per_mm"]
    u, v = np.meshgrid(np.arange(n) * pitch, np.arange(n) * pitch, indexing="ij")
    pts = np.stack([u.ravel(), v.ravel(),
                    kx * (u.ravel() - cx) ** 2 + ky * (v.ravel() - cy) ** 2], 1)
    return pts + rng.normal(scale=spec["jitter_mm"], size=pts.shape)


def surface_and_electrodes(config: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(points (N, 3) float64, triangles (M, 3) int32, electrodes (E, 3))."""
    surf, elec = config["surface"], config["electrodes"]
    if surf["kind"] == "plane_patch":
        points, tris = plane_patch(surf)
        return points, tris, grid_on_patch(elec, surf)
    if surf["kind"] == "s1_grid":
        coords = curved_grid(elec)
        points, tris = s1_reconstruct.reconstruct_surface(
            coords, smooth_iters=surf["smooth_iters"], subdivisions=surf["subdivisions"])
        return points, np.asarray(tris, np.int32), coords
    raise ValueError(f"unknown surface kind {surf['kind']!r}")


class Waves:
    """The pool's wave parameters, drawn from the seed."""

    def __init__(self, electrodes: np.ndarray, waves: dict, pool: int, seed: int):
        self.rng = np.random.default_rng(seed)
        lo, hi = electrodes.min(axis=0), electrodes.max(axis=0)
        k = waves["sources"]
        slots = self.rng.permutation(pool)
        frac = slots / max(pool - 1, 1)
        f_lo, f_hi = waves["freq_hz"]
        c_lo, c_hi = waves["speed_mm_per_ms"]
        self.freq = (f_lo + (f_hi - f_lo) * frac)[:, None] * np.array(waves["source_freq_ratio"][:k])
        self.speed = (c_lo + (c_hi - c_lo) * frac[::-1])[:, None] * np.ones(k)
        inner = waves["source_region"]
        self.center = lo + (hi - lo) * self.rng.uniform(inner[0], inner[1], size=(pool, k, 3))
        self.center[..., 2] = 0.5 * (lo[2] + hi[2])
        self.phase = self.rng.uniform(0, 2 * np.pi, size=(pool, k))
        self.amp = np.array(waves["amplitude"][:k])
        self.noise = waves["noise"]

    def wavelength_mm(self) -> np.ndarray:
        return self.speed * 1000.0 / self.freq          # mm/ms * ms/s / Hz

    def field(self, item: int, where: np.ndarray, t: np.ndarray) -> np.ndarray:
        """Sum of pool item `item`'s waves at points `where` (P, 3) and
        times t (S,): (S, P)."""
        out = 0.0
        for s in range(self.freq.shape[1]):
            r = np.linalg.norm(where - self.center[item, s], axis=-1)
            out = out + self.amp[s] * np.cos(
                2 * np.pi * self.freq[item, s] * t[:, None]
                - 2 * np.pi * r[None, :] / self.wavelength_mm()[item, s] + self.phase[item, s])
        return out


def epochs(waves: Waves, electrodes: np.ndarray, sfreq: float, tmin: float,
           tmax: float, pool: int) -> np.ndarray:
    """(pool, S, E) float64 electrode recordings over the whole epoch."""
    t = tmin + np.arange(int(round((tmax - tmin) * sfreq))) / sfreq
    out = np.empty((pool, t.size, len(electrodes)))
    for i in range(pool):
        sig = waves.field(i, electrodes, t)
        out[i] = sig + waves.noise * waves.rng.standard_normal(sig.shape)
    return out


@dataclass
class Inputs:
    """One run's inputs on the host: the surface, the electrodes, the pool
    of epochs (P, S, E), the S2 window [start, stop) of samples and the
    window's frame times, and the configuration's pipeline settings."""

    points: np.ndarray
    tris: np.ndarray
    coords: np.ndarray
    epochs: np.ndarray
    sfreq: float
    window: tuple
    times: np.ndarray
    pipeline: dict
    waves: Waves

    @classmethod
    def make(cls, config: dict, traffic: dict, seed: int) -> "Inputs":
        points, tris, coords = surface_and_electrodes(config)
        rec, pipe = config["recording"], config["pipeline"]
        sfreq = float(traffic.get("sfreq", rec["sfreq"]))
        waves = Waves(coords, traffic["waves"], traffic["pool"], seed)
        ep = epochs(waves, coords, sfreq, rec["tmin_s"], rec["tmax_s"], traffic["pool"])
        start = int(pipe["interpolation"]["start_time"] * sfreq)
        stop = int(pipe["interpolation"]["end_time"] * sfreq)
        times = np.arange(stop - start, dtype=np.float64) / sfreq
        return cls(points, tris, coords, ep, sfreq, (start, stop), times, pipe, waves)

    def velocity_movies(self, device, seed: int, noise: float):
        """(P, T-1, 2N) velocity movies of the pool's waves on `device`,
        made there in bulk from the seed (see `velocity_movies`)."""
        import torch

        from flowbench.reference.geometry import tangent_basis, vertex_normals

        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % 2 ** 63)
        basis = tangent_basis(vertex_normals(self.points, self.tris.astype(np.int64)))
        t = self.times[:-1] + self.window[0] / self.sfreq
        return velocity_movies(self.waves, torch.as_tensor(self.points, device=device),
                               torch.as_tensor(basis, device=device),
                               torch.as_tensor(t, device=device), len(self.epochs),
                               noise, gen)


def velocity_movies(waves: Waves, points, basis, t, pool: int, noise: float, generator):
    """(pool, T, 2N) velocity coefficients of the same waves on the surface:
    each source's amplitude times its unit radial direction, on each
    vertex's tangent basis, with seeded noise. `points`, `basis` (N, 2, 3)
    and `t` (T,) are torch tensors on the device the movies are made on,
    `generator` a torch.Generator there."""
    import torch

    out = []
    for i in range(pool):
        v = 0.0
        for s in range(waves.freq.shape[1]):
            d = points - torch.as_tensor(waves.center[i, s], dtype=points.dtype,
                                         device=points.device)
            r = torch.sqrt((d * d).sum(-1)).clamp_min(1e-9)
            arg = (2 * np.pi * waves.freq[i, s] * t[:, None]
                   - 2 * np.pi * r[None, :] / waves.wavelength_mm()[i, s] + waves.phase[i, s])
            v = v + waves.amp[s] * torch.cos(arg)[..., None] * (d / r[:, None])[None]
        dofs = torch.cat([(v * basis[:, 0]).sum(-1), (v * basis[:, 1]).sum(-1)], dim=1)
        dofs += noise * torch.randn(dofs.shape, generator=generator, dtype=dofs.dtype,
                                    device=dofs.device)
        out.append(dofs)
    return torch.stack(out)
