"""The port's renderers (viz.fields) and its rendering CLI options held
against the JAX package's, on the CPU (matplotlib Agg; no display).

Where both packages draw the same arrays (the same numpy inputs, or modes
handed from one package to the other), the images must be equal pixel for
pixel: `fig.canvas.buffer_rgba()` of each figure, the pixels of each PNG,
every frame of each GIF. Where each package draws arrays it computed itself
(its own SVD's modes, its own demo solve), the drawn arrays are compared
within a stated tolerance and the images by size, frame count and a bound on
the share of pixels that differ:
  * mode world vectors sigma_i VT_i: 1e-9 of their largest entry (6e-15
    measured: the two SVDs are LAPACK's);
  * the demo's velocity fields: 1e-6 of the largest (2e-15 measured: on the
    CPU both demos solve with float64 cg at tol 1e-8);
  * images: at most 1% of the pixels differ (none measured: arrows that move
    by 1e-14 of their length move no pixel).
"""

import json
import pickle

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image, ImageSequence  # noqa: E402

from manifold_flow_tpu import viz as jax_viz  # noqa: E402
from manifold_flow_tpu.geometry import synthetic as jax_synthetic  # noqa: E402
from manifold_flow_tpu.ops import svd as jax_svd  # noqa: E402
from manifold_flow_tpu.pipeline import cli as jax_cli  # noqa: E402
from manifold_flow_tpu.utils import io as jax_io  # noqa: E402
from manifold_flow_tpu_torch import mesh_from_jax_arrays, viz  # noqa: E402
from manifold_flow_tpu_torch.ops import svd  # noqa: E402
from manifold_flow_tpu_torch.pipeline import cli  # noqa: E402
from manifold_flow_tpu_torch.utils import io  # noqa: E402
from manifold_flow_tpu_torch.viz import fields  # noqa: E402
from tests.torch_parity import jax_arrays  # noqa: E402

MODES_TOL = 1e-9
DEMO_TOL = 1e-6
PIXEL_SHARE = 0.01


@pytest.fixture(scope="module")
def problem():
    """The 8x8 patch and seeded velocities of tests/test_viz.py, in both
    packages."""
    jmesh = jax_synthetic.plane_patch(nx=8, ny=8, lx=4.0, ly=4.0)
    mesh = mesh_from_jax_arrays(jax_arrays(jmesh), device="cpu")
    v = np.random.default_rng(0).normal(size=(2, mesh.n_vertices, 3)) * 0.1
    return jmesh, mesh, v


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close("all")


def pixels(fig) -> np.ndarray:
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


def frames(path) -> list[np.ndarray]:
    with Image.open(path) as im:
        return [np.asarray(f.convert("RGBA")) for f in ImageSequence.Iterator(im)]


def image(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def assert_same_pixels(got: list, want: list) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g, w)


def assert_close_pixels(got: list, want: list) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.mean(np.any(g != w, axis=-1)) <= PIXEL_SHARE


def test_plot_velocity_frame(problem):
    """Scaled arrows with scalars, detections and a title; raw arrows with
    the true-vs-detected overlay; tensors and arrays alike."""
    jmesh, mesh, v = problem
    pts = np.asarray(jmesh.points)
    kw = dict(scalars=pts[:, 0], singularities=pts[:3], scaling="scaled", title="frame 0")
    want = pixels(jax_viz.plot_velocity_frame(jmesh, v[0], **kw))
    got = pixels(viz.plot_velocity_frame(mesh, torch.from_numpy(v[0]), **{
        **kw, "scalars": mesh.points[:, 0]}))
    assert_same_pixels([got], [want])
    kw = dict(scaling="raw", true_singularities=pts[:1])
    assert_same_pixels([pixels(viz.plot_velocity_frame(mesh, v[0], **kw))],
                       [pixels(jax_viz.plot_velocity_frame(jmesh, v[0], **kw))])
    with pytest.raises(ValueError, match="arrow scaling"):
        viz.plot_velocity_frame(mesh, v[0], scaling="bogus")


def test_animate_velocity_fields(problem, tmp_path):
    jmesh, mesh, v = problem
    sing = [np.asarray(jmesh.points)[:2]] * 2
    kw = dict(times=np.asarray([0.0, 0.01]), fps=2, dpi=40)
    jax_viz.animate_velocity_fields(jmesh, v, tmp_path / "j.gif",
                                    singularities_per_frame=sing, **kw)
    out = viz.animate_velocity_fields(mesh, torch.from_numpy(v), tmp_path / "t.gif",
                                      singularities_per_frame=[mesh.points[:2]] * 2, **kw)
    assert str(out).endswith("t.gif")
    assert_same_pixels(frames(tmp_path / "t.gif"), frames(tmp_path / "j.gif"))


def test_plot_temporal_modes(tmp_path):
    rng = np.random.default_rng(1)
    vt = rng.normal(size=(4, 16))
    sigma = np.sort(rng.uniform(1, 10, size=4))[::-1].copy()
    times = np.linspace(0, 1, 16)
    want = pixels(jax_viz.plot_temporal_modes(times, vt, sigma, n_modes=3,
                                              save_path=tmp_path / "j.png"))
    got = pixels(viz.plot_temporal_modes(torch.from_numpy(times), torch.from_numpy(vt),
                                         sigma, n_modes=3, save_path=tmp_path / "t.png"))
    assert_same_pixels([got], [want])
    assert_same_pixels([image(tmp_path / "t.png")], [image(tmp_path / "j.png")])


def test_plot_streamlines(problem, tmp_path):
    jmesh, mesh, _ = problem
    pts = np.asarray(jmesh.points)
    want = pixels(jax_viz.plot_streamlines(jmesh, [pts[:5], pts[10:18]],
                                           save_path=tmp_path / "j.png"))
    got = pixels(viz.plot_streamlines(mesh, [mesh.points[:5], pts[10:18]],
                                      save_path=tmp_path / "t.png"))
    assert_same_pixels([got], [want])
    assert_same_pixels([image(tmp_path / "t.png")], [image(tmp_path / "j.png")])


def test_true_vs_detected_gif(problem, tmp_path):
    """The simulated-data validation animation: detected and true points
    per frame (draw_optical_flow_field.py:258-319)."""
    jmesh, mesh, v = problem
    pts = np.asarray(jmesh.points)
    kw = dict(singularities_per_frame=[pts[:2], pts[3:4]],
              true_singularities_per_frame=[pts[5:7]] * 2, fps=2, dpi=40)
    jax_viz.animate_velocity_fields(jmesh, v, tmp_path / "j.gif", **kw)
    viz.animate_velocity_fields(mesh, v, tmp_path / "t.gif", **kw)
    assert_same_pixels(frames(tmp_path / "t.gif"), frames(tmp_path / "j.gif"))


@pytest.mark.parametrize("form", ["concat", "complex"])
def test_plot_spatial_modes_both_forms(problem, tmp_path, form):
    """extract_modes for the complex and concat decompositions
    (S4_...ComplexMatrices .py:145-162): the same modes draw the same
    pixels; each package's own SVD draws the same mode vectors within
    MODES_TOL."""
    jmesh, mesh, _ = problem
    v_k = np.random.default_rng(2).normal(size=(6, 2 * mesh.n_vertices))
    jax_fn = jax_svd.decompose_concat if form == "concat" else jax_svd.decompose_complex
    fn = svd.decompose_concat if form == "concat" else svd.decompose_complex
    jmodes = jax_fn(v_k, n_modes=3)
    want = jax_viz.plot_spatial_modes(jmesh, jmodes, n_modes=2,
                                      save_path_fmt=tmp_path / "j_{mode}.png")
    handed = svd.SVDModes(*(torch.from_numpy(np.array(x)) for x in jmodes))
    got = viz.plot_spatial_modes(mesh, handed, n_modes=2,
                                 save_path_fmt=tmp_path / "t_{mode}.png")
    assert len(got) == len(want) == 2
    assert_same_pixels([pixels(f) for f in got], [pixels(f) for f in want])
    for i in (1, 2):
        assert_same_pixels([image(tmp_path / f"t_{i}.png")], [image(tmp_path / f"j_{i}.png")])
    own = fn(torch.from_numpy(v_k), n_modes=3)
    vt = np.asarray(jmodes.vt)
    if not np.iscomplexobj(vt):
        vt = vt[..., : mesh.n_vertices] + 1j * vt[..., mesh.n_vertices:]
    svt = np.asarray(jmodes.sigma)[:2, None] * vt[:2]
    basis = np.asarray(jmesh.basis)
    world = (np.real(svt)[..., None] * basis[:, 0] + np.imag(svt)[..., None] * basis[:, 1])
    mine = fields.mode_world_vectors(mesh, own, 2).numpy()
    assert np.abs(mine - world).max() <= MODES_TOL * np.abs(world).max()
    figs = viz.plot_spatial_modes(mesh, own, n_modes=2)
    assert_close_pixels([pixels(f) for f in figs], [pixels(f) for f in want])


def test_freesurfer_roundtrip_and_pial_underlay(problem, tmp_path):
    """FreeSurfer binary surface codec and the translucent pial underlay
    (plot_pial_surfaces, S4_...ConcatMatrices .py:147-158), through the
    port's reader (MNE is not installed)."""
    jmesh, mesh, v = problem
    pial_v = np.asarray(jmesh.points) * 2.0 + np.array([0.0, 0.0, -1.0])
    pial_f = np.asarray(jmesh.triangles)
    path = tmp_path / "lh.pial"
    io.write_freesurfer_surface(path, pial_v, pial_f)
    rv, rf = io.read_freesurfer_surface(path)
    np.testing.assert_allclose(rv, pial_v, rtol=1e-6)
    np.testing.assert_array_equal(rf, pial_f)
    underlay = viz.load_pial_surfaces(path)
    want = jax_viz.plot_velocity_frame(jmesh, v[0], underlay=jax_viz.load_pial_surfaces(path),
                                       title="with pial underlay")
    got = viz.plot_velocity_frame(mesh, v[0], underlay=underlay, title="with pial underlay")
    assert_same_pixels([pixels(got)], [pixels(want)])


def test_pyvista_plotter_names_pyvista(problem):
    _, mesh, v = problem
    with pytest.raises(ImportError, match="PyVista"):
        viz.pyvista_plotter(mesh, v[0])


@pytest.fixture(scope="module")
def artifacts(problem, tmp_path_factory):
    """A surface, its bases and a 3-frame V_k movie with scalars and
    singularities, written in the reference formats."""
    jmesh, _, _ = problem
    d = tmp_path_factory.mktemp("artifacts")
    rng = np.random.default_rng(5)
    n = jmesh.n_vertices
    pts = np.asarray(jmesh.points)
    jax_io.write_ply(d / "s.ply", pts, np.asarray(jmesh.triangles))
    jax_io.save_e_csv(d / "e.csv", np.asarray(jmesh.basis))
    jax_io.save_indexed_csv(d / "V_k.csv", rng.normal(size=(3, 2 * n)) * 0.1)
    jax_io.save_indexed_csv(d / "scalars.csv", rng.normal(size=(3, n)))
    jax_io.save_pickle(d / "sing.pkl", [pts[:2], pts[4:5], pts[:0]])
    jax_io.save_pickle(d / "true.pkl", [pts[7:8]] * 3)
    io.write_freesurfer_surface(d / "lh.pial", pts * 2.0 - 1.0, np.asarray(jmesh.triangles))
    return d


def _both_clis(argv, tmp_path, capsys):
    """argv through the JAX CLI into tmp_path/j and the port's (on the CPU)
    into tmp_path/t; their JSON lines."""
    args = jax_cli.build_parser().parse_args(argv + ["--out-dir", str(tmp_path / "j")])
    args.func(args)
    want = json.loads(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu", "--out-dir", str(tmp_path / "t")]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["device"] == "cpu"
    return got, want


VISUALIZE = {
    "png": ([], "velocity_frame_0.png"),
    "png_raw_pial": (["--frame", "1", "--scaling", "raw", "--stride", "2",
                      "--pial", "{d}/lh.pial"], "velocity_frame_1.png"),
    "gif": (["--gif", "--sfreq", "512"], "velocity_fields.gif"),
    "gif_true": (["--gif", "--true-singularities", "{d}/true.pkl"], "true_vs_detected.gif"),
}


@pytest.mark.parametrize("case", sorted(VISUALIZE))
def test_visualize_cli_matches_jax(artifacts, tmp_path, capsys, case):
    """visualize (a frame as PNG, or the movie as GIF) on the same artifacts
    through both CLIs: the same keys and pixel-equal images."""
    d = artifacts
    extra, name = VISUALIZE[case]
    argv = ["visualize", "--surface", str(d / "s.ply"), "--e", str(d / "e.csv"),
            "--v-k", str(d / "V_k.csv"), "--scalars", str(d / "scalars.csv"),
            "--singularities", str(d / "sing.pkl"), *(a.format(d=d) for a in extra)]
    got, want = _both_clis(argv, tmp_path, capsys)
    assert set(got["timings"]) == {"load", "render"}
    assert {k: v for k, v in got.items() if k not in ("device", "timings", "png", "gif")} == \
        {k: v for k, v in want.items() if k not in ("png", "gif")}
    read = frames if name.endswith(".gif") else (lambda p: [image(p)])
    assert_same_pixels(read(tmp_path / "t" / name), read(tmp_path / "j" / name))


@pytest.mark.parametrize("pial", [False, True], ids=["plain", "pial"])
def test_decompose_render_modes_cli(artifacts, tmp_path, capsys, pial):
    """decompose --render-modes, with and without a --pial underlay: the same
    npz and rendered list as JAX, each package's own SVD drawn within the
    pixel bound."""
    d = artifacts
    argv = ["decompose", "--v-k", str(d / "V_k.csv"), "--render-modes", "2",
            "--surface", str(d / "s.ply")] + (["--pial", str(d / "lh.pial")] if pial else [])
    got, want = _both_clis(argv, tmp_path, capsys)
    assert got["energy_pct"] == pytest.approx(want["energy_pct"], abs=1e-9)
    names = [p.split("/")[-1] for p in got["rendered_modes"]]
    assert names == [p.split("/")[-1] for p in want["rendered_modes"]] == [
        "spatial_mode_1.png", "spatial_mode_2.png"]
    assert "render" in got["timings"]
    assert_close_pixels([image(tmp_path / "t" / n) for n in names],
                        [image(tmp_path / "j" / n) for n in names])


def test_render_modes_without_surface_exits(artifacts, tmp_path):
    """As in JAX: --render-modes needs --surface (after the npz is written)."""
    argv = ["decompose", "--v-k", str(artifacts / "V_k.csv"), "--render-modes", "2",
            "--device", "cpu", "--out-dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="--render-modes requires --surface"):
        cli.main(argv)
    assert (tmp_path / "data_01.npz").exists()


def test_demo_gif_cli_matches_jax(tmp_path, capsys):
    """demo --gif: the true-vs-detected GIF of each package's own solve and
    detections, of the same size and frame count, within the pixel bound;
    the drawn velocity fields within DEMO_TOL."""
    argv = ["demo", "--nx", "10", "--frames", "4", "--gif"]
    got, want = _both_clis(argv, tmp_path, capsys)
    assert got["gif"].endswith("true_vs_detected.gif") and want["gif"]
    for key in ("frames", "converged", "matched", "missed", "spare"):
        assert got[key] == want[key], key
    assert "gif" in got["timings"]
    v = [io.load_indexed_csv(tmp_path / side / "V_k.csv") for side in "tj"]
    assert np.abs(v[0] - v[1]).max() <= DEMO_TOL * np.abs(v[1]).max()
    with open(tmp_path / "t" / "singularity_points.pkl", "rb") as fh:
        mine = pickle.load(fh)
    with open(tmp_path / "j" / "singularity_points.pkl", "rb") as fh:
        theirs = pickle.load(fh)
    assert [len(p) for p in mine] == [len(p) for p in theirs]
    assert_close_pixels(frames(tmp_path / "t" / "true_vs_detected.gif"),
                        frames(tmp_path / "j" / "true_vs_detected.gif"))
