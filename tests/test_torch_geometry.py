"""Geometry of the PyTorch port held against the JAX package.

Float arrays agree to 1e-12 of their largest entry: both sides evaluate the
same float64 formulas, and only reduction order (norms, cross products,
BLAS) differs. Topology tables are equal entry for entry, incident-cell
order included, since that order fixes the matvec's summation order.
"""

import numpy as np
import pytest
import torch

from manifold_flow_tpu.geometry import mesh as jax_mesh_mod
from manifold_flow_tpu.geometry import synthetic as jax_synthetic
from manifold_flow_tpu.geometry import tangent as jax_tangent
from manifold_flow_tpu_torch import mesh_from_jax_arrays
from manifold_flow_tpu_torch.geometry import synthetic as torch_synthetic
from manifold_flow_tpu_torch.geometry import tangent as torch_tangent
from manifold_flow_tpu_torch.geometry.mesh import ARRAY_FIELDS, build_mesh
from manifold_flow_tpu_torch.pipeline import stages
from manifold_flow_tpu_torch.utils import io
from tests.torch_parity import bump, jax_arrays, rel_err

RTOL = 1e-12

MESHES = {
    "curved_patch": lambda syn, **kw: syn.plane_patch(nx=12, ny=12, lx=6.0, ly=6.0,
                                                      height=bump, **kw),
    "sphere": lambda syn, **kw: syn.sphere_patch(n_sub=2, **kw),
}


def _assert_same_mesh(got, want_arrays):
    for name in ARRAY_FIELDS:
        want = want_arrays[name]
        have = getattr(got, name).numpy()
        assert have.shape == want.shape and have.dtype == want.dtype, name
        if want.dtype.kind == "f":
            assert rel_err(have, want) <= RTOL, name
        else:
            np.testing.assert_array_equal(have, want, err_msg=name)


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_build_mesh_matches_jax(kind):
    want = jax_arrays(MESHES[kind](jax_synthetic))
    got = MESHES[kind](torch_synthetic, device="cpu")
    _assert_same_mesh(got, want)
    assert got.n_vertices == want["points"].shape[0]
    assert got.n_dof == 2 * got.n_vertices


def test_build_mesh_with_given_normals():
    arrays = jax_arrays(MESHES["curved_patch"](jax_synthetic))
    normals = arrays["normals"] * 1.0
    want = jax_arrays(jax_mesh_mod.build_mesh(arrays["points"],
                                              arrays["triangles"], normals))
    got = build_mesh(arrays["points"], arrays["triangles"], normals, device="cpu")
    _assert_same_mesh(got, want)


def test_build_mesh_rejects_bad_triangles():
    arrays = jax_arrays(MESHES["curved_patch"](jax_synthetic))
    for tris in (arrays["triangles"][:, :2], arrays["triangles"] + 1,
                 arrays["triangles"] - 1):
        with pytest.raises(ValueError):
            build_mesh(arrays["points"], tris, device="cpu")


def test_mesh_from_jax_arrays_is_exact():
    arrays = jax_arrays(MESHES["curved_patch"](jax_synthetic))
    got = mesh_from_jax_arrays(arrays, device="cpu")
    for name in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), arrays[name])
    moved = got.to("cpu")
    for name in ARRAY_FIELDS:
        assert torch.equal(getattr(moved, name), getattr(got, name))


def test_mesh_from_jax_arrays_refuses_padding_and_gaps():
    jm = MESHES["curved_patch"](jax_synthetic)
    padded = jax_mesh_mod.pad_mesh(jm)
    arrays = jax_arrays(padded)
    arrays["n_valid_vertices"] = np.asarray(padded.n_valid_vertices)
    arrays["n_valid_triangles"] = np.asarray(padded.n_valid_triangles)
    with pytest.raises(ValueError, match="padded"):
        mesh_from_jax_arrays(arrays, device="cpu")
    arrays = jax_arrays(jm)
    del arrays["edges"]
    with pytest.raises(ValueError, match="missing"):
        mesh_from_jax_arrays(arrays, device="cpu")


def test_tangent_helpers_match_jax():
    rng = np.random.default_rng(3)
    n = rng.standard_normal((64, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[0] = [0.0, 0.0, 1.0]  # the (nx, ny) == 0 branch
    want_e = np.asarray(jax_tangent.tangent_basis(n))
    got_e = torch_tangent.tangent_basis(torch.from_numpy(n)).numpy()
    assert rel_err(got_e, want_e) <= RTOL
    e1, e2 = want_e[:, 0], want_e[:, 1]
    a, b = rng.standard_normal((2, 64, 3))
    t = [torch.tensor(v) for v in (a, b, e1, e2)]
    cases = [
        (jax_tangent.project_to_plane(a, e1, e2),
         torch_tangent.project_to_plane(t[0], t[2], t[3])),
        (jax_tangent.express_on_basis(a, e1, e2),
         torch_tangent.express_on_basis(t[0], t[2], t[3])),
        (jax_tangent.position_diff_on_basis(a, b, e1, e2),
         torch_tangent.position_diff_on_basis(t[0], t[1], t[2], t[3])),
    ]
    for want, got in cases:
        assert rel_err(got.numpy(), np.asarray(want)) <= RTOL


def test_synthetic_movies_match_jax():
    jm = MESHES["curved_patch"](jax_synthetic)
    tm = MESHES["curved_patch"](torch_synthetic, device="cpu")
    for want, got in zip(jax_synthetic.plane_wave_movie(jm, n_frames=5),
                         torch_synthetic.plane_wave_movie(tm, n_frames=5)):
        np.testing.assert_array_equal(got.numpy(), want)
    for want, got in zip(jax_synthetic.two_source_movie(jm, n_frames=5),
                         torch_synthetic.two_source_movie(tm, n_frames=5)):
        np.testing.assert_array_equal(got.numpy(), want)


ENTRY_POINTS = {
    "build_mesh": lambda arrays, tmp: build_mesh(arrays["points"], arrays["triangles"]),
    "plane_patch": lambda arrays, tmp: torch_synthetic.plane_patch(nx=4, ny=4),
    "sphere_patch": lambda arrays, tmp: torch_synthetic.sphere_patch(n_sub=0),
    "load_surface": lambda arrays, tmp: stages.load_surface(tmp),
    "mesh_from_jax_arrays": lambda arrays, tmp: mesh_from_jax_arrays(arrays),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_gpu_and_raise_without_one(entry, tmp_path,
                                                              monkeypatch):
    """The mesh entry points run on the card unless the caller asks for the
    CPU; without a GPU the default raises, naming device="cpu", and never
    falls back to the CPU quietly."""
    arrays = jax_arrays(MESHES["curved_patch"](jax_synthetic))
    ply = tmp_path / "s.ply"
    io.write_ply(ply, arrays["points"], arrays["triangles"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[entry](arrays, ply)
