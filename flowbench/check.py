"""The comparison that decides `correct`.

The port's outputs of a sample of the window's requests (drawn from the
seed) are held against the plain reference (`flowbench.reference`), which
works everything out again from the same inputs. Each number below is the
worst over the sampled requests; each has a limit in
`limits/<workload>.json`, set from the readings PERF.md gives.

- `amp`: S2's amplitude movie, max |port - ref| / max |ref|, every frame.
- `phase`: S2's phase movie, the largest wrapped angle gap (rad).
- `wave`: S5's wave speeds, the largest |port - ref| / max(|port|, |ref|)
  over the finite entries; a finite entry where the other side has none
  reads inf.
- `svd`: S4, judged on the movie the port decomposed: the largest of the
  singular values' gaps to LAPACK's, the residuals |A v - s u| and
  |A^T u - s v|, all over the first singular value, the modes' norms' gaps
  to 1, and 1 for a mode whose temporal mean is negative (the sign rule).
- `velocity`: S3's solve, on the sampled frames: |port - ref| / |ref| of
  the world vectors (N, 3), the reference solving each frame directly.
- `singularities`: S3's detection and classification on the sampled
  frames: the Hausdorff distance (mm) between the port's points and those
  the reference finds in its own solution, class by class; a class that
  one side has and the other not reads the surface's diameter.
"""

from __future__ import annotations

import numpy as np

from flowbench.reference import analysis, fields, flow, rbf
from flowbench.reference.geometry import Surface


def reference(inp, stages: list[str], item: int, frames: list[int], dtype=np.float64,
              whole_movie: bool = False, surface: Surface | None = None,
              svd_input: np.ndarray | None = None) -> dict:
    """The outputs the port's stages give for pool item `item`, computed by
    the reference in `dtype`: every output the judge compares, on the
    sampled `frames` for the solve. With `whole_movie` (the control) it
    solves every frame and decomposes its own movie, so that it can stand
    in the port's place; otherwise S4's input is `svd_input`."""
    pipe = inp.pipeline
    interp = pipe["interpolation"]
    if pipe.get("reference_quirks"):
        raise ValueError("the reference implements reference_quirks=False only")
    s = surface or Surface(inp.points, inp.tris, dtype)
    start, stop = inp.window
    sig = inp.epochs[item].astype(dtype)
    out = {}
    kind, smooth = interp["kind"], interp["smooth"]
    amp = rbf.amplitude(inp.coords, sig[start:stop], s.points, kind, smooth, dtype)
    if "interpolate" in stages:
        out["amp"] = amp
    if "interpolate_phases" in stages:
        phi = rbf.hilbert_phase(sig, dtype)[start:stop]
        out["phase"] = rbf.phases(inp.coords, phi, s.points, kind, smooth, dtype)
    if "wavespeed" in stages:
        out["wave"] = fields.wave_speed_phase(s, out["phase"], 1.0 / inp.sfreq)
    if "velocity" in stages:
        lam = pipe["solver"]["lambda_"]
        a2 = flow.regularization(s)
        times = inp.times.astype(dtype)
        todo = range(len(times) - 1) if whole_movie else frames
        dofs = {k: flow.solve_frame(s, a2, amp, float(times[k + 1] - times[k]), k, lam)
                for k in todo}
        out["v_world"] = {k: flow.to_world(s, dofs[k]) for k in frames}
        out["sing"] = {k: analysis.singularities(s, out["v_world"][k], pipe["solver"]["eps"])
                       for k in frames}
        if whole_movie:
            svd_input = np.stack([dofs[k] for k in todo])
    if "decompose" in stages and whole_movie:
        out["svd_input"] = svd_input
        out["modes"] = fields.svd_modes(svd_input.astype(dtype), pipe["analysis"]["n_modes"])
    return out


def _amp(p, r):
    return float(np.max(np.abs(p - r)) / np.max(np.abs(r)))


def _phase(p, r):
    return float(np.max(np.abs(np.angle(np.exp(1j * (p.astype(np.float64) - r))))))


def _wave(p, r):
    p = p.astype(np.float64)
    fp, fr = np.isfinite(p), np.isfinite(r)
    if np.any(fp != fr):
        return float("inf")
    a, b = p[fp], r[fr]
    den = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.finfo(np.float64).tiny)
    return float(np.max(np.abs(a - b) / den)) if a.size else 0.0


def _svd(a, modes, n_modes):
    u, sig, vt = (np.asarray(x, dtype=np.float64) for x in modes)
    a = np.asarray(a, dtype=np.float64)
    ref = fields.singular_values(a, n_modes)
    scale = ref[0]
    worst = [np.max(np.abs(sig - ref)) / scale,
             np.max(np.linalg.norm(a @ vt.T - u * sig, axis=0)) / scale,
             np.max(np.linalg.norm(a.T @ u - vt.T * sig, axis=0)) / scale,
             np.max(np.abs(np.linalg.norm(u, axis=0) - 1)),
             np.max(np.abs(np.linalg.norm(vt, axis=1) - 1)),
             float(np.any(u.mean(axis=0) < 0))]
    return float(max(worst)) if len(sig) == n_modes else float("inf")


def _velocity(p, r):
    return max(float(np.linalg.norm(p[k] - r[k]) / np.linalg.norm(r[k])) for k in r)


def _hausdorff(a, b):
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    return float(max(d.min(axis=1).max(), d.min(axis=0).max()))


def _singularities(p, r, diameter):
    worst = 0.0
    for k in r:
        (pp, pl), (rp, rl) = p[k], r[k]
        for c in set(pl.tolist()) | set(rl.tolist()):
            a, b = pp[pl == c], rp[rl == c]
            worst = max(worst, diameter if len(a) == 0 or len(b) == 0 else _hausdorff(a, b))
    return worst


def numbers(program: dict, ref: dict, surface: Surface, n_modes: int) -> dict:
    """Each compared number of one request, by name."""
    out = {}
    if "amp" in ref:
        out["amp"] = _amp(program["amp"], ref["amp"])
    if "phase" in ref:
        out["phase"] = _phase(program["phase"], ref["phase"])
    if "wave" in ref:
        out["wave"] = _wave(program["wave"], ref["wave"])
    if "modes" in program:
        out["svd"] = _svd(program["svd_input"], program["modes"], n_modes)
    if "v_world" in ref:
        out["velocity"] = _velocity(program["v_world"], ref["v_world"])
        out["singularities"] = _singularities(program["sing"], ref["sing"], surface.diameter)
    return out


def judge(inp, stages: list[str], sampled: list, frames: list[int]) -> dict:
    """The worst of each number over the sampled requests [(item, outputs)]."""
    surface = Surface(inp.points, inp.tris, np.float64)
    worst: dict = {}
    for item, program in sampled:
        ref = reference(inp, stages, item, frames, surface=surface)
        for name, value in numbers(program, ref, surface,
                                   inp.pipeline["analysis"]["n_modes"]).items():
            value = float("inf") if np.isnan(value) else value
            worst[name] = max(worst.get(name, value), value)
    return worst


def verdict(values: dict, limits: dict) -> dict:
    """correct: every number at or under its limit (a number without a limit
    fails); numbers: {name: [value, limit]}."""
    table = {name: [value, limits.get(name)] for name, value in sorted(values.items())}
    ok = bool(table) and all(lim is not None and value <= lim
                             for value, lim in table.values())
    return {"correct": ok, "numbers": table}
