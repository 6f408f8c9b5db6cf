"""The port's multi-device layer (manifold_flow_tpu_torch/parallel) and its
wiring into the stages, pipeline.batch and the CLI, held against the JAX
package on the CPU.

The port runs one process per rank: gloo CPU ranks spawned with
torch.multiprocessing (tests/torch_dist.py holds their bodies, which import
no JAX), once per layout group in module-scoped fixtures. The JAX package
runs in this process, on conftest's 8 virtual CPU devices where a sharded
JAX function is the reference, else its single-device function (which its
own tests/test_parallel.py holds the sharded ones to). Tolerances are
tests/test_parallel.py's: cg layouts rtol 1e-7 / atol 1e-10 against the
tol 1e-12 solve, refined RMSE below 1e-7 of max|v|, two-level rtol 1e-6 /
atol 1e-9, iterations within 2; discrete analysis outputs equal, floats to
1e-12 (detection), 1e-10 (wave speeds), 1e-6 (winding numbers).
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manifold_flow_tpu.geometry import synthetic as jax_synthetic
from manifold_flow_tpu.parallel import build_partition as jax_build_partition
from manifold_flow_tpu.solve.api import compute_velocity_fields as jax_solve
from manifold_flow_tpu_torch.geometry import synthetic
from manifold_flow_tpu_torch.parallel import comm as pcomm
from manifold_flow_tpu_torch.parallel import halo, make_device_mesh, multihost, scaling
from manifold_flow_tpu_torch.pipeline import batch, cli
from manifold_flow_tpu_torch.pipeline.config import PipelineConfig
from tests import torch_dist as td

torch.set_num_threads(1)

CG = dict(tol=1e-12)
LAYOUTS = [
    # name, frames, mesh, movie frames, solve kwargs
    ("frames_4x1", 4, 1, 7, CG),
    ("mesh_1x4", 1, 4, 7, CG),
    ("frames_x_mesh_2x2", 2, 2, 7, CG),
    ("uneven_4x1", 4, 1, 6, CG),
    ("uneven_2x2", 2, 2, 6, CG),
    ("refined_frames_4x1", 4, 1, 7, dict(tol=1e-9, method="refined")),
    ("refined_mesh_1x4", 1, 4, 7, dict(tol=1e-9, method="refined")),
    ("refined_frames_two_level_4x1", 4, 1, 7,
     dict(tol=1e-9, method="refined", precond="two_level")),
    ("refined_mesh_two_level_1x4", 1, 4, 7,
     dict(tol=1e-9, method="refined", precond="two_level")),
    ("halo_jacobi_2x2", 2, 2, 7, dict(tol=1e-10, precond="jacobi")),
    ("halo_two_level_2x2", 2, 2, 7, dict(tol=1e-10, precond="two_level")),
]
CG_NAMES = [n for n, *_, kw in LAYOUTS if kw is CG]
REFINED_NAMES = ["refined_frames_4x1", "refined_mesh_1x4"]
TWO_LEVEL_NAMES = ["refined_frames_two_level_4x1", "refined_mesh_two_level_1x4",
                   "halo_jacobi_2x2", "halo_two_level_2x2"]


def jax_problem_mesh():
    return jax_synthetic.plane_patch(nx=14, ny=14, lx=7.0, ly=7.0,
                                     height=lambda x, y: 0.2 * np.sin(x) * np.cos(y))


@pytest.fixture(scope="module")
def four():
    """One spawn of 4 gloo ranks: every 4-rank layout, each rank's result."""
    return multihost.spawn(td.four_ranks, 4, (LAYOUTS,))


@pytest.fixture(scope="module")
def reference():
    """tests/test_parallel.py's reference: JAX's single-device cg at tol
    1e-12, on 7 frames and on the first 6."""
    mesh = jax_problem_mesh()
    pot, times = jax_synthetic.plane_wave_movie(mesh, n_frames=7)
    out = {}
    for n in (7, 6):
        res = jax_solve(mesh, jnp.asarray(pot[:n]), jnp.asarray(times[:n]), method="cg",
                        tol=1e-12)
        out[n] = (np.asarray(res.v_k), int(res.iterations))
    return out


def _layout(name):
    return next(lay for lay in LAYOUTS if lay[0] == name)


def _same_on_every_rank(four, name):
    first = four[0]["solve"][name]
    for r in four[1:]:
        np.testing.assert_array_equal(r["solve"][name]["v_k"], first["v_k"])
        assert r["solve"][name]["iterations"] == first["iterations"]
    return first


@pytest.mark.parametrize("name", CG_NAMES)
def test_cg_layouts_match_jax(four, reference, name):
    """Frames (4, 1), mesh (1, 4), frames x mesh (2, 2) and uneven padding
    (5 velocity frames over 4 or 2 frame ranks): every rank holds the same
    global result, within test_parallel.py's tolerance of JAX's solve and
    within 2 of its iterations."""
    got = _same_on_every_rank(four, name)
    want, iters = reference[_layout(name)[3]]
    assert got["converged"].all()
    assert got["v_k"].shape == want.shape
    np.testing.assert_allclose(got["v_k"], want, rtol=1e-7, atol=1e-10)
    assert abs(got["iterations"] - iters) <= 2


@pytest.mark.parametrize("name", REFINED_NAMES)
def test_refined_layouts_match_jax(four, reference, name):
    got = _same_on_every_rank(four, name)
    want = reference[7][0]
    assert got["converged"].all()
    rmse = np.sqrt(np.mean((got["v_k"] - want) ** 2)) / np.abs(want).max()
    assert rmse < 1e-7, rmse


@pytest.mark.parametrize("name", TWO_LEVEL_NAMES)
def test_two_level_layouts_match_jax(four, reference, name):
    """Two-level on frames and on the mesh (the halo coarse matrices
    assembled per shard by K8 and all-reduced), and the halo solve with
    Jacobi: the same solution."""
    got = _same_on_every_rank(four, name)
    assert got["converged"].all()
    np.testing.assert_allclose(got["v_k"], reference[7][0], rtol=1e-6, atol=1e-9)


def test_halo_two_level_needs_no_more_iterations_than_jacobi(four):
    solve = four[0]["solve"]
    assert solve["halo_two_level_2x2"]["iterations"] <= solve["halo_jacobi_2x2"]["iterations"]


def test_halo_refined_two_level_matches_jax_sharded(four):
    """The JAX package's own halo refined two-level solve (1 x 8 virtual
    devices) and the port's (1 x 4 ranks) agree to its tolerance."""
    from manifold_flow_tpu.parallel import halo_refined_velocity_fields, make_device_mesh as jmesh

    mesh = jax_problem_mesh()
    pot, times = jax_synthetic.plane_wave_movie(mesh, n_frames=7)
    res = halo_refined_velocity_fields(mesh, jnp.asarray(pot, jnp.float64),
                                       jnp.asarray(times, jnp.float64), jmesh(1, 8),
                                       tol=1e-9, precond="two_level")
    want = np.asarray(res.v_k)
    got = four[0]["solve"]["refined_mesh_two_level_1x4"]["v_k"]
    rmse = np.sqrt(np.mean((got - want) ** 2)) / np.abs(want).max()
    assert rmse < 1e-7, rmse


@pytest.mark.parametrize("nm", [4, 2])
def test_halo_matvec_and_rhs_equal_the_global_rows(four, nm):
    """K1 after the exchange, and K4 on the local block, give each shard's
    owned rows of the global matvec and RHS; the halo and pad rows of the
    product are zero; CPU tensors stage nothing."""
    for r in four:
        got = r["matvec"][nm]
        np.testing.assert_allclose(got["y"], got["want"], rtol=1e-12,
                                   atol=1e-12 * np.abs(got["want"]).max())
        np.testing.assert_allclose(got["f"], got["f_want"], rtol=1e-12,
                                   atol=1e-12 * np.abs(got["f_want"]).max())
        assert got["off_owned"] == 0.0
        assert got["staged"] == {"to_host": 0, "to_device": 0}
        # The plain path (exchange, local_contributions, reduce_owned) is the
        # wrapper's plain version on CPU tensors: the same rows bit for bit.
        np.testing.assert_array_equal(got["plain"], got["y_local"])


# ---------------------------------------------------------------- tables --
def _tables_equal(mesh_t, mesh_j, n):
    got = halo.build_partition(mesh_t, n)
    want = jax_build_partition(mesh_j, n)
    for name in ("owner", "owned_slot", "owned_ids", "tri_ids", "tri_corners",
                 "dof_local", "base6", "base3", "send_idx", "halo_src", "asm_w"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("n_shards", "v_owned", "v_halo", "m_local", "b_send"):
        assert getattr(got, name) == getattr(want, name), name
    return got


@pytest.mark.parametrize("n", [2, 4, 8])
def test_partition_tables_equal_jax(n):
    mesh = td.solve_mesh()
    _tables_equal(mesh, jax_problem_mesh(), n)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_partition_tables_equal_jax_at_12k(n):
    """tests/test_parallel.py:105's 12.5k patch (host only): the tables are
    equal, every vertex is owned once, and owned + halo rows are a small
    share of the vertices."""
    def height(x, y):
        return 2.0 * np.sin(x / 9.0) * np.cos(y / 11.0)

    mesh_t = synthetic.plane_patch(nx=112, ny=112, lx=60.0, ly=60.0, height=height,
                                   device="cpu")
    mesh_j = jax_synthetic.plane_patch(nx=112, ny=112, lx=60.0, ly=60.0, height=height)
    part = _tables_equal(mesh_t, mesh_j, n)
    total = mesh_t.n_vertices
    assert part.v_owned <= -(-total // n) + 1
    valid = part.owned_ids[part.owned_ids < total]
    assert valid.size == total and np.unique(valid).size == total
    if n == 8:
        assert part.v_owned + part.v_halo < 0.2 * total and part.b_send < 0.1 * total


def test_coarse_partition_tables_equal_jax():
    from manifold_flow_tpu.parallel import halo as jax_halo
    from manifold_flow_tpu.solve import coarse as jax_coarse
    from manifold_flow_tpu_torch.solve import coarse

    mesh_t, mesh_j = td.solve_mesh(), jax_problem_mesh()
    for n in (2, 4):
        _, members_j, agg_j = jax_halo._coarse_partition_tables(
            mesh_j, jax_build_partition(mesh_j, n), jax_coarse.build_tables(mesh_j))
        members, agg = halo._coarse_partition_tables(
            mesh_t, halo.build_partition(mesh_t, n), coarse.build_tables(mesh_t))
        np.testing.assert_array_equal(members, np.asarray(members_j))
        np.testing.assert_array_equal(agg, np.asarray(agg_j))


def test_owned_global_round_trip_matches_jax():
    from manifold_flow_tpu.parallel import halo as jax_halo

    mesh_t, mesh_j = td.solve_mesh(), jax_problem_mesh()
    x = np.random.default_rng(td.SEED).standard_normal((3, mesh_t.n_dof))
    part_t, part_j = halo.build_partition(mesh_t, 4), jax_build_partition(mesh_j, 4)
    owned = halo.global_to_owned(part_t, torch.as_tensor(x))
    np.testing.assert_array_equal(owned.numpy(),
                                  np.asarray(jax_halo.global_to_owned(part_j, jnp.asarray(x))))
    back = halo.owned_to_global(part_t, owned.reshape(3, -1), mesh_t.n_vertices)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_halo_comm_stats_equal_jax(n):
    from manifold_flow_tpu.parallel import halo_comm_stats as jax_stats
    from manifold_flow_tpu.parallel import predicted_efficiency as jax_eff

    got = scaling.halo_comm_stats(td.solve_mesh(), n)
    want = jax_stats(jax_problem_mesh(), n)
    assert got.__dict__ == want.__dict__
    assert scaling.predicted_efficiency(got, 1000.0, 100.0) == jax_eff(want, 1000.0, 100.0)
    assert 0.0 < scaling.predicted_efficiency(got) <= 1.0


def test_measure_scaling_mechanism():
    """Keys and the baseline of 1.0, positive values; no wall-clock bound
    (ROADMAP C10: the host's other workers set the times)."""
    out = scaling.measure_scaling(n_devices=(1, 2), frames_per_device=3, nx=10, tol=1e-4,
                                  device="cpu")
    assert set(out["weak_eff"]) == set(out["strong_eff"]) == {"1", "2"}
    assert out["weak_eff"]["1"] == 1.0 and out["strong_eff"]["1"] == 1.0
    for v in (*out["weak_eff"].values(), *out["strong_eff"].values(),
              *out["weak_fps"].values(), *out["strong_fps"].values()):
        assert v > 0


# ---------------------------------------------------------------- analysis --
@pytest.fixture(scope="module")
def analysis(four):
    """The ranks' analysis results and JAX's single-device ops on the same
    velocity movie (the port's, 7 frames over 4 frame ranks: padded)."""
    from manifold_flow_tpu.ops import singularity as jsing
    from manifold_flow_tpu.ops import wavespeed as jwave
    from manifold_flow_tpu.ops import winding as jwind

    mesh = jax_synthetic.plane_patch(
        nx=16, ny=16, lx=10.0, ly=10.0,
        height=lambda x, y: 0.3 * np.sin(0.8 * x) * np.cos(0.6 * y))
    got = four[0]["analysis"]
    v3, pot = jnp.asarray(got["v3"]), got["pot"]
    field, counts = jsing.detect_with_counts(mesh, v3)
    pts, valid, centers = got["winding_inputs"]
    return got, {
        "field": field, "counts": np.asarray(counts),
        "phase": np.asarray(jwave.wave_velocity_phase_mm_per_ms(
            mesh, jnp.asarray(np.angle(np.exp(1j * pot))), 1e-3)),
        "amplitude": np.asarray(jwave.wave_velocity_amplitude(mesh, jnp.asarray(pot), 1e-3)),
        "winding": jwind.analyze_singularities_movie(mesh, v3, pts, valid, max_level=6,
                                                     centers=centers)}


@pytest.mark.parametrize("which", ["field", "field_plain"])
def test_sharded_detect_matches_jax(analysis, four, which):
    got, want = analysis
    field = got[which]
    assert field[0].shape[0] == 7
    np.testing.assert_array_equal(field[0], np.asarray(want["field"].vertex_mask))
    np.testing.assert_array_equal(field[1], np.asarray(want["field"].interior_mask))
    np.testing.assert_allclose(field[4], np.asarray(want["field"].v_max), rtol=1e-12)
    im = field[1]
    np.testing.assert_allclose(field[3][im], np.asarray(want["field"].interior_point)[im],
                               rtol=1e-12)
    for r in four[1:]:
        for a, b in zip(r["analysis"][which], field):
            np.testing.assert_array_equal(a, b)


def test_sharded_detect_with_counts_matches_jax(analysis):
    got, want = analysis
    np.testing.assert_array_equal(got["counts"], want["counts"])


@pytest.mark.parametrize("method", ["phase", "amplitude"])
def test_sharded_wave_velocity_matches_jax(analysis, method):
    got, want = analysis
    assert got[method].shape == want[method].shape
    np.testing.assert_allclose(got[method], want[method], rtol=1e-10, atol=1e-12)


def test_sharded_winding_matches_jax(analysis):
    got, want = analysis
    counts, types, ws = got["winding"]
    assert got["winding_inputs"][1].any()
    np.testing.assert_array_equal(counts, np.asarray(want["winding"].counts))
    np.testing.assert_array_equal(types, np.asarray(want["winding"].types))
    np.testing.assert_allclose(ws, np.asarray(want["winding"].winding_numbers),
                               rtol=1e-6, atol=1e-9)
    for a, b in zip(got["winding"], got["winding_single"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- stages --
@pytest.mark.parametrize("key", ["v_k", "points", "wavespeed", "winding"])
def test_stages_with_device_mesh_match_one_device(four, key):
    """velocity, singularity, wavespeed and winding stages with a (4, 1)
    device mesh against the same stages on one device: the solve within
    tolerance, the analysis equal; every rank holds the result."""
    for r in four:
        got, want = r["stages"]["sharded"], r["stages"]["single"]
        if key == "v_k":
            np.testing.assert_allclose(got["v_k"], want["v_k"], rtol=1e-7, atol=1e-10)
            assert abs(got["iterations"] - want["iterations"]) <= 2
        elif key == "points":
            assert len(got["points"]) == len(want["points"])
            for a, b in zip(got["points"], want["points"]):
                np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)
        elif key == "wavespeed":
            np.testing.assert_array_equal(got["wavespeed"], want["wavespeed"])
        else:
            assert sorted(got["winding"]) == sorted(want["winding"])
            for k in want["winding"]:
                assert [row[1:] for row in got["winding"][k]] == [
                    row[1:] for row in want["winding"][k]]


def test_sharded_stages_write_on_rank_zero_only(four):
    """Each rank wrote into its own directory: rank 0 every artifact of
    both runs, the other ranks only those of the single-device run."""
    names = {"V_k.csv", "sing.pkl", "ws.pkl", "wind.pkl"}
    assert set(four[0]["stages"]["written"]) == {f"{t}_{n}" for t in ("single", "sharded")
                                                for n in names}
    for r in four[1:]:
        assert set(r["stages"]["written"]) == {f"single_{n}" for n in names}


# ---------------------------------------------------------------- batch --
@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    """A results tree swept in one process, and four copies swept by 2 gloo
    ranks: run_batch(distributed=True), `batch --distributed`, `batch
    --frame-shards 2`, and run_batch on a (2, 1) mesh whose rank 0 fails its
    writes. The solve's tol is 1e-12 in all four (the tolerance
    of test_parallel.py's layouts): frame blocks iterate their frames
    differently, so the frame-sharded solve equals the one-process solve
    to that tolerance, not bit for bit."""
    from tests.test_torch_batch import make_tree

    base = tmp_path_factory.mktemp("dist_batch")
    config = base / "config.yaml"
    config.write_text("general:\n  tol: 1.0e-12\n")
    one = make_tree(base / "one")
    roots = {}
    for name in ("run_batch", "cli_distributed", "cli_frame_shards", "failing"):
        roots[name] = base / name
        shutil.copytree(one, roots[name])
    single = batch.run_batch(one, PipelineConfig.from_yaml(config), device="cpu")
    ranks = multihost.spawn(td.batch_layout, 2, (
        str(roots["run_batch"]), str(roots["cli_distributed"]),
        str(roots["cli_frame_shards"]), str(roots["failing"]), str(config)), timeout=300)
    return one, roots, single, ranks


def test_run_batch_distributed_splits_trials(batches):
    from tests.test_torch_batch import KEYS, assert_same_artifacts

    one, roots, single, ranks = batches
    reports = [r["report"] for r in ranks]
    assert [rep["shard"] for rep in reports] == [[0, 2], [1, 2]]
    assert sorted(reports[0]["trials"]) == [KEYS[0], KEYS[2]]
    assert sorted(reports[1]["trials"]) == [KEYS[1]]
    assert not reports[0]["errors"] and not reports[1]["errors"]
    merged = {**reports[0]["trials"], **reports[1]["trials"]}
    assert merged == single["trials"]
    assert_same_artifacts(roots["run_batch"], one)


@pytest.mark.parametrize("name", ["cli_distributed", "cli_frame_shards"])
def test_batch_cli_on_two_ranks(batches, name):
    """`batch --distributed` splits the trials; `batch --frame-shards 2` runs
    every trial on both ranks (each rank reports all of them) and rank 0
    writes: both trees equal the one-process sweep's."""
    from tests.test_torch_batch import assert_same_artifacts

    one, roots, single, ranks = batches
    key = name.split("_", 1)[1]
    outs = [r["cli"][key] for r in ranks]
    assert all(rc == 0 for rc, _ in outs)
    if key == "frame_shards":
        assert all(rep["trials"] == single["trials"] for _, rep in outs)
    else:
        assert sorted(k for _, rep in outs for k in rep["trials"]) == sorted(single["trials"])
    assert_same_artifacts(roots[name], one)


def test_a_write_that_fails_on_rank_zero_fails_on_every_rank(batches):
    """Under a device mesh rank 0 alone writes, so it alone sees a failed
    write. Both ranks record the same errors, naming rank 0 and its
    OSError, and go on in step: every trial is reported, and the sweep
    returned on both ranks (no rank was left waiting in a collective)."""
    from tests.test_torch_batch import KEYS

    reports = [r["failing"] for r in batches[3]]
    assert reports[0]["errors"] == reports[1]["errors"]
    assert reports[0]["trials"] == reports[1]["trials"]
    assert reports[0]["errors"]
    for message in reports[0]["errors"].values():
        assert "rank 0 of 2 failed: OSError: no space left on device" in message
    for rep in reports:
        assert set(rep["trials"]) | {k for k in rep["errors"] if k in KEYS} == set(KEYS)


# ---------------------------------------------------------------- one process --
def test_without_a_process_group_the_multi_rank_options_raise(tmp_path, monkeypatch):
    """No process group and no torchrun environment: a mesh of more than
    one rank, run_batch(distributed=True) and the batch CLI's options raise
    ValueError naming torchrun; --frame-shards with --distributed and
    device_mesh with distributed raise as meaningless in one process per
    rank (ROADMAP Queue C)."""
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        make_device_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        batch.run_batch(tmp_path, PipelineConfig(), distributed=True, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        cli.main(["batch", "--root", str(tmp_path), "--device", "cpu", "--frame-shards", "2"])
    with pytest.raises(ValueError, match="torchrun"):
        cli.main(["batch", "--root", str(tmp_path), "--device", "cpu", "--distributed"])
    with pytest.raises(ValueError, match="pass one"):
        cli.main(["batch", "--root", str(tmp_path), "--device", "cpu", "--frame-shards", "2",
                  "--distributed"])
    with pytest.raises(ValueError, match="pass one"):
        batch.run_batch(tmp_path, PipelineConfig(), distributed=True,
                        device_mesh=make_device_mesh(1, 1, device="cpu"), device="cpu")
    assert multihost.is_primary() and multihost.world_size() == 1


def test_one_rank_mesh_runs_without_a_group(reference):
    """A 1 x 1 mesh needs no process group: its collectives are no-ops and
    the halo solve equals JAX's (test_parallel.py's tolerance)."""
    dm = make_device_mesh(1, 1, device="cpu")
    assert dm.shape == {"frames": 1, "mesh": 1} and dm.comm("mesh").group is None
    mesh = td.solve_mesh()
    pot, times = td.solve_movie(mesh)
    res = halo.halo_compute_velocity_fields(mesh, pot, times, dm, tol=1e-12)
    np.testing.assert_allclose(res.v_k.numpy(), reference[7][0], rtol=1e-7, atol=1e-10)
    with pytest.raises(ValueError, match="needs a process group"):
        pcomm.AxisComm(None, size=2)
    x = torch.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(dm.comm("frames").all_gather(x).numpy(), x[None].numpy())
    y = x.clone()
    dm.comm("mesh").all_reduce_(y)
    np.testing.assert_array_equal(y.numpy(), x.numpy())
