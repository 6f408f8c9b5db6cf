"""The port's S1 (geometry/reconstruct.py, reconstruct_stage and the
`reconstruct` command line) held against the JAX package on the CPU.

The port keeps a copy of the JAX module, which is numpy and scipy on the
host, so its outputs must equal JAX's bit for bit. On top of that: the
port's counterparts of tests/test_butterfly.py (the published
modified-butterfly stencils, Zorin, Schroeder & Sweldens 1996), and
properties of the Laplacian smoothing (vtkSmoothPolyDataFilter's rule),
each held by both packages.
"""

import json

import numpy as np
import pytest
import torch

from manifold_flow_tpu.geometry import reconstruct as jax_reconstruct
from manifold_flow_tpu.pipeline import cli as jax_cli
from manifold_flow_tpu.pipeline import stages as jax_stages
from manifold_flow_tpu.pipeline.config import PipelineConfig as JaxConfig
from manifold_flow_tpu_torch.geometry import reconstruct
from manifold_flow_tpu_torch.geometry.mesh import ARRAY_FIELDS
from manifold_flow_tpu_torch.pipeline import cli, stages
from manifold_flow_tpu_torch.pipeline.config import PipelineConfig
from manifold_flow_tpu_torch.utils import io
from tests.test_butterfly import boundary_vertices, edge_list, icosphere, lattice, valences

PACKAGES = pytest.mark.parametrize("rec", [jax_reconstruct, reconstruct],
                                   ids=["jax", "torch"])


def grid_electrodes(n=8, spacing=10.0, seed=0):
    """An n x n clinical grid (10 mm pitch) laid on a gently curved sheet,
    with seeded jitter: the layout S1 reconstructs (S1_reconstruct_
    surface.py:53-68)."""
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.arange(n) * spacing, np.arange(n) * spacing, indexing="ij")
    pts = np.stack([u.ravel(), v.ravel(),
                    0.004 * (u.ravel() - 35.0) ** 2 + 0.002 * (v.ravel() - 30.0) ** 2], 1)
    return pts + rng.normal(scale=0.3, size=pts.shape)


def stencil_weights(tris, n):
    """{edge: {vertex: weight}} of the port's butterfly_subdivide, read off
    its output on the identity matrix (it is linear in the coordinates and
    indifferent to their width; tests/test_butterfly.py)."""
    w, _ = reconstruct.butterfly_subdivide(np.eye(n), tris, n_subdiv=1)
    out = {}
    for k, e in enumerate(edge_list(tris)):
        row = w[n + k]
        nz = np.flatnonzero(np.abs(row) > 1e-14)
        out[e] = {int(i): row[i] for i in nz}
    return out


# ------------------------------------------------------- held against JAX ----
@pytest.mark.parametrize("case", ["lattice", "noisy_lattice_x2", "icosphere", "grid"])
def test_subdivide_delaunay_and_smooth_equal_jax(case):
    rng = np.random.default_rng(1)
    if case == "grid":
        pts = grid_electrodes(5)
        tris = reconstruct.delaunay_2d(pts)
        np.testing.assert_array_equal(tris, jax_reconstruct.delaunay_2d(pts))
        assert tris.dtype == np.int32
    elif case == "icosphere":
        pts, tris = icosphere(1)
    else:
        pts, tris = lattice(6, 5)
        if case.startswith("noisy"):
            pts = pts + 0.05 * rng.standard_normal(pts.shape)
    n_subdiv = 2 if case.endswith("x2") else 1
    got = reconstruct.butterfly_subdivide(pts, tris, n_subdiv=n_subdiv)
    want = jax_reconstruct.butterfly_subdivide(pts, tris, n_subdiv=n_subdiv)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        reconstruct.laplacian_smooth(*got, n_iter=7),
        jax_reconstruct.laplacian_smooth(*want, n_iter=7))


def test_reconstruct_surface_equals_jax():
    """The full S1 pipeline on a 6 x 6 grid (three subdivisions, 100 + 100
    smoothing passes), and the stage's mesh equal to the mesh built from
    the same arrays."""
    coords = grid_electrodes(6)
    got = reconstruct.reconstruct_surface(coords)
    want = jax_reconstruct.reconstruct_surface(coords)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].shape == (64 * len(reconstruct.delaunay_2d(coords)), 3)
    res = stages.reconstruct_stage(coords, PipelineConfig(), device="cpu")
    np.testing.assert_array_equal(res.points, got[0])
    np.testing.assert_array_equal(res.triangles, got[1])
    assert res.mesh.device.type == "cpu" and res.mesh.n_vertices == len(got[0])
    np.testing.assert_array_equal(res.mesh.points.numpy(), got[0])


def test_reconstruct_cli_matches_jax(tmp_path, capsys):
    """`reconstruct` on an electrodes.tsv (grid rows, a strip row and an
    'n/a' row, both skipped): the PLY equals JAX's, and the mesh loaded from
    it equals the JAX mesh's arrays."""
    coords = grid_electrodes(5, seed=2)
    rows = ["name\tx\ty\tz\tgroup"] + [
        f"G{i}\t" + "\t".join(repr(float(x)) for x in p) + "\tgrid"
        for i, p in enumerate(coords)] + ["S1\t1\t2\t3\tstrip", "G99\tn/a\tn/a\tn/a\tgrid"]
    (tmp_path / "electrodes.tsv").write_text("\n".join(rows) + "\n")
    args = ["reconstruct", "--electrodes", str(tmp_path / "electrodes.tsv")]
    assert cli.main(args + ["--device", "cpu", "--out-dir", str(tmp_path / "t")]) == 0
    got = json.loads(capsys.readouterr().out)
    jax_args = jax_cli.build_parser().parse_args(args + ["--out-dir", str(tmp_path / "j")])
    jax_args.func(jax_args)
    want = json.loads(capsys.readouterr().out)
    for key in ("stage", "n_vertices", "n_triangles"):
        assert got[key] == want[key], key
    assert got["device"] == "cpu" and got["n_vertices"] > 25 * 16
    name = "reconstructed_surface.ply"
    assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    mesh = stages.load_surface(tmp_path / "t" / name, device="cpu")
    jmesh = jax_stages.load_surface(tmp_path / "j" / name)
    for field in ARRAY_FIELDS:
        np.testing.assert_allclose(getattr(mesh, field).numpy(),
                                   np.asarray(getattr(jmesh, field)),
                                   rtol=1e-12, atol=1e-12, err_msg=field)


def test_reconstruct_runs_on_the_default_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        stages.reconstruct_stage(grid_electrodes(3), PipelineConfig())
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        cli.main(["reconstruct", "--electrodes", "e.tsv", "--out-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())
    assert vars(JaxConfig().reconstruction) == vars(PipelineConfig().reconstruction)


# ------------------------------------- butterfly stencils (port's copy) ----
def test_interpolating_old_vertices_fixed():
    pts, tris = lattice(6, 6)
    pts = pts + 0.05 * np.random.default_rng(0).standard_normal(pts.shape)
    new_pts, _ = reconstruct.butterfly_subdivide(pts, tris, n_subdiv=2)
    np.testing.assert_array_equal(new_pts[: len(pts)], pts)


@pytest.mark.parametrize("mesh", ["lattice", "icosphere"])
def test_all_stencils_affine_invariant(mesh):
    tris, n = (lattice(6, 5)[1], 30) if mesh == "lattice" else (icosphere(1)[1], 42)
    for e, row in stencil_weights(tris, n).items():
        assert abs(sum(row.values()) - 1.0) < 1e-12, e


def test_regular_interior_weights():
    pts, tris = lattice(8, 8)
    n = len(pts)
    val, bd = valences(tris, n), boundary_vertices(tris)
    checked = 0
    for (a, b), row in stencil_weights(tris, n).items():
        if a in bd or b in bd or val[a] != 6 or val[b] != 6 or any(v in bd for v in row):
            continue
        assert sorted(row.values()) == pytest.approx(
            4 * [-1.0 / 16.0] + 2 * [1.0 / 8.0] + 2 * [1.0 / 2.0])
        assert row[a] == pytest.approx(0.5) and row[b] == pytest.approx(0.5)
        checked += 1
    assert checked >= 10


def test_boundary_edge_weights():
    pts, tris = lattice(7, 5)
    n = len(pts)
    bd = boundary_vertices(tris)
    cells = {}
    for tri in tris:
        for i in range(3):
            e = tuple(sorted((tri[i], tri[(i + 1) % 3])))
            cells[e] = cells.get(e, 0) + 1
    checked = 0
    for (a, b), row in stencil_weights(tris, n).items():
        if cells[(a, b)] != 1 or len(row) != 4:
            continue
        assert row[a] == pytest.approx(9.0 / 16.0) and row[b] == pytest.approx(9.0 / 16.0)
        outer = [v for v in row if v not in (a, b)]
        assert all(v in bd for v in outer)
        assert all(row[v] == pytest.approx(-1.0 / 16.0) for v in outer)
        checked += 1
    assert checked >= 4


def test_extraordinary_vertex_weights_valence5():
    v, tris = icosphere(1)
    n = len(v)
    val = valences(tris, n)
    k = 5
    s = np.array([(0.25 + np.cos(2 * np.pi * j / k) + 0.5 * np.cos(4 * np.pi * j / k)) / k
                  for j in range(k)])
    checked = 0
    for (a, b), row in stencil_weights(tris, n).items():
        if {val[a], val[b]} != {5, 6}:
            continue
        center, other = (a, b) if val[a] == 5 else (b, a)
        assert row[center] == pytest.approx(0.75)
        assert row[other] == pytest.approx(s[0])
        assert sorted(w for key, w in row.items() if key != center) == pytest.approx(sorted(s))
        checked += 1
    assert checked >= 20


def test_cubic_precision_regular_region():
    pts, tris = lattice(10, 9)
    x, y = pts[:, 0], pts[:, 1]

    def cubic(x, y):
        return (0.7 * x**3 - 1.3 * x**2 * y + 0.4 * x * y**2 + 0.9 * y**3
                - 2.0 * x * y + 0.8 * x - 1.1 * y + 0.3)

    pts[:, 2] = cubic(x, y)
    n = len(pts)
    bd = boundary_vertices(tris)
    w = stencil_weights(tris, n)
    new_pts, _ = reconstruct.butterfly_subdivide(pts, tris, n_subdiv=1)
    checked = 0
    for k, e in enumerate(edge_list(tris)):
        if any(v in bd for v in w[e]):
            continue
        p = new_pts[n + k]
        assert p[0] == pytest.approx(0.5 * (pts[e[0], 0] + pts[e[1], 0]), abs=1e-12)
        assert p[2] == pytest.approx(cubic(p[0], p[1]), abs=1e-9)
        checked += 1
    assert checked >= 50


def test_convergence_on_sphere():
    errs = []
    for level in (2, 3):
        v, f = icosphere(level)
        new_pts, _ = reconstruct.butterfly_subdivide(v, f, n_subdiv=1)
        errs.append(np.abs(np.linalg.norm(new_pts[len(v):], axis=1) - 1.0).max())
    assert errs[0] < 4e-3
    assert errs[1] < errs[0] / 4.0


def test_closed_surface_counts():
    v, f = icosphere(1)
    nv, nf = reconstruct.butterfly_subdivide(v, f, n_subdiv=1)
    assert len(nv) == len(v) + len(edge_list(f)) and len(nf) == 4 * len(f)
    assert len(nv) - len(edge_list(nf)) + len(nf) == 2


# ---------------------------------- Laplacian smoothing, both packages ----
@PACKAGES
def test_smooth_zero_passes_is_identity(rec):
    pts, tris = lattice(6, 5)
    pts = pts + 0.1 * np.random.default_rng(2).standard_normal(pts.shape)
    out = rec.laplacian_smooth(pts, tris, n_iter=0)
    np.testing.assert_array_equal(out, pts)
    assert out is not pts and out.dtype == np.float64


@PACKAGES
def test_smooth_one_pass_moves_by_the_relaxation(rec):
    """One pass moves each vertex `relaxation` of the way to the mean of its
    neighbours: boundary vertices to the mean of their boundary neighbours."""
    pts, tris = lattice(5, 4)
    pts = pts + 0.1 * np.random.default_rng(3).standard_normal(pts.shape)
    out = rec.laplacian_smooth(pts, tris, n_iter=1, relaxation=0.3)
    bd = boundary_vertices(tris)
    edges = edge_list(tris)
    count = {e: 0 for e in edges}
    for tri in tris:
        for i in range(3):
            count[tuple(sorted((tri[i], tri[(i + 1) % 3])))] += 1
    for v in range(len(pts)):
        nb = [b if a == v else a for a, b in edges if v in (a, b)
              and (v not in bd or count[(a, b)] == 1)]
        want = pts[v] + 0.3 * (pts[nb].mean(axis=0) - pts[v])
        np.testing.assert_allclose(out[v], want, rtol=0, atol=1e-14)


@PACKAGES
def test_smooth_is_translation_and_plane_equivariant(rec):
    """Every pass is an affine combination (weights summing to 1): a
    translated mesh smooths to the translated result, and a mesh in a
    plane stays in it."""
    rng = np.random.default_rng(4)
    pts, tris = lattice(7, 6)
    pts = pts + 0.1 * rng.standard_normal(pts.shape) * [1, 1, 0]
    shift = np.array([12.5, -3.25, 7.0])
    a = rec.laplacian_smooth(pts, tris, n_iter=20)
    b = rec.laplacian_smooth(pts + shift, tris, n_iter=20)
    np.testing.assert_allclose(b - shift, a, rtol=0, atol=1e-12)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    tilted = rec.laplacian_smooth(pts @ q.T, tris, n_iter=20)
    np.testing.assert_allclose((tilted @ q)[:, 2], 0.0, atol=1e-12)


@PACKAGES
def test_smooth_keeps_regular_lattice_but_corners(rec):
    """On a regular lattice every interior vertex is the mean of its six
    neighbours and every straight-edge boundary vertex the mean of its two:
    one pass moves only the corners, inward, and never grows the bounding
    box."""
    pts, tris = lattice(6, 5)
    out = rec.laplacian_smooth(pts, tris, n_iter=1)
    moved = np.flatnonzero(np.abs(out - pts).max(axis=1) > 1e-12)
    assert sorted(moved.tolist()) == [0, 5, 24, 29]
    many = rec.laplacian_smooth(pts, tris, n_iter=100)
    assert (many.min(axis=0) >= pts.min(axis=0) - 1e-12).all()
    assert (many.max(axis=0) <= pts.max(axis=0) + 1e-12).all()


@PACKAGES
def test_smooth_shrinks_noise(rec):
    """Smoothing a noisy sheet lowers its roughness (the sum of squared
    differences along edges) at every step count."""
    pts, tris = lattice(8, 8)
    pts = pts + 0.2 * np.random.default_rng(5).standard_normal(pts.shape)
    edges = np.asarray(edge_list(tris))

    def roughness(p):
        return float(((p[edges[:, 0]] - p[edges[:, 1]]) ** 2).sum())

    values = [roughness(rec.laplacian_smooth(pts, tris, n_iter=k)) for k in (0, 10, 50, 100)]
    assert values == sorted(values, reverse=True) and values[-1] < values[0]
