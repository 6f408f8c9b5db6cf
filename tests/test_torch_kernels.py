"""The port's CUDA kernels against their plain torch versions, on a GPU.

These tests need an NVIDIA GPU and nvcc (a CUDA kernel has no CPU mode) and
skip without one. They import no JAX, so on a machine with a GPU and no JAX
they run without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances, relative to each output's largest entry: 1e-5 in float32 (the
kernels contract a*b+c into fused multiply-adds and sum in another order)
and 1e-12 in float64; the same for K8's coarse matrices, a sum of each
entry's contributions reordered against the plain version's. The analysis
kernels (K5-K7, K12, K13, K15) round every deciding operation separately, in
the plain versions' order, so their masks, counts, ids, snapped centers,
class codes, next hops and ring counts must be equal; K14 works on integers
only, so walk lengths and packed walks are equal.
"""

import numpy as np
import pytest
import torch

from manifold_flow_tpu_torch import compute_velocity_fields, kernels
from manifold_flow_tpu_torch.fem import assembly
from manifold_flow_tpu_torch.fem.operator import jacobi_inputs, make_operator
from manifold_flow_tpu_torch.geometry import synthetic, topology
from manifold_flow_tpu_torch.kernels import analysis as kan
from manifold_flow_tpu_torch.kernels import coarse as kco
from manifold_flow_tpu_torch.kernels import fem as kfem
from manifold_flow_tpu_torch.kernels import fields as kfi
from manifold_flow_tpu_torch.kernels import streams as kst
from manifold_flow_tpu_torch.kernels import winding as kwi
from manifold_flow_tpu_torch.ops import interpolate as interp
from manifold_flow_tpu_torch.ops import recombine
from manifold_flow_tpu_torch.ops import singularity as sing
from manifold_flow_tpu_torch.ops import streamline as stream
from manifold_flow_tpu_torch.ops import wavespeed as wave
from manifold_flow_tpu_torch.ops import winding as wind
from manifold_flow_tpu_torch.pipeline import stages
from manifold_flow_tpu_torch.pipeline.config import PipelineConfig
from manifold_flow_tpu_torch.solve import coarse
from manifold_flow_tpu_torch.solve.api import build_rhs
from tests.torch_rings import synthetic_rings
from tests.torch_walks import around_the_cap

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _problem(device):
    mesh = synthetic.plane_patch(
        nx=12, ny=12, lx=6.0, ly=6.0, device=device,
        height=lambda x, y: 0.8 * np.exp(-((x - 3.0) ** 2 + (y - 3.0) ** 2) / 4.0))
    pot, times = synthetic.plane_wave_movie(mesh, n_frames=6)
    pot = pot + 0.05 * torch.from_numpy(
        np.random.default_rng(0).standard_normal(tuple(pot.shape))).to(device)
    return mesh, pot, times


def _assert_close(got, want, dtype):
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
        assert err <= TOL[dtype]


def _launched(name, dtype, fn):
    """fn()'s result, checking that it launched kernel `name` once (its
    `dtype` instance; None for the integer entry points)."""
    ctype = {torch.float32: "float", torch.float64: "double", None: "int"}[dtype]
    before = kernels.LAUNCHES[f"{name}<{ctype}>"]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[f"{name}<{ctype}>"] == before + 1
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_fem_kernels_match_plain(cuda, dtype):
    mesh, pot, times = _problem(cuda)
    base = assembly.gather_base_table(mesh)
    ff = (pot.to(dtype), pot.to(dtype), times.to(dtype), mesh.triangles,
          mesh.grad_w.to(dtype), mesh.basis.to(dtype), mesh.areas.to(dtype), base)
    got = _launched("frame_factors_rhs", dtype, lambda: kfem.frame_factors_rhs(*ff))
    _assert_close(got, kfem.plain_frame_factors_rhs(*ff), dtype)

    g, f = build_rhs(mesh, pot, times)
    op = make_operator(mesh, g, 0.01).astype(dtype)
    x = torch.randn(tuple(f.shape), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64).to(cuda, dtype)
    fd = f.to(dtype)
    mv = (x, op.dof, op.blocks2, op.g, op.w_scale, op.lambda_, op.gather_base)
    got = _launched("fem_matvec", dtype, lambda: kfem.fem_matvec(*mv, op.tiles))
    _assert_close([got], [kfem.plain_fem_matvec(*mv)], dtype)
    got = _launched("fem_matvec", dtype, lambda: kfem.fem_matvec(*mv, op.tiles, f=fd))
    want = kfem.plain_fem_matvec(*mv, f=fd)
    scale = float(fd.abs().max()) + float(kfem.plain_fem_matvec(*mv).abs().max())
    assert float((got - want).abs().max()) / scale <= TOL[dtype]

    jb = (op.g, assembly.corner_regularization(mesh, dtype).contiguous(),
          mesh.areas.to(dtype), op.lambda_, base)
    got = _launched("jacobi_blocks", dtype, lambda: kfem.jacobi_blocks(*jb))
    _assert_close([got], [kfem.plain_jacobi_blocks(*jb)], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("size", [64, 256])
@pytest.mark.parametrize("shape", ["sphere", "plane"])
def test_fem_matvec_matches_plain_on_any_tiling(cuda, dtype, size, shape):
    """K1 on a sphere patch (valence 5 and 6, padded table rows) and on a
    391-vertex plane patch (no multiple of either tile size), 5 frames (no
    multiple of the frames a block takes), with and without f; two calls
    are bitwise equal."""
    if shape == "sphere":
        mesh = synthetic.sphere_patch(n_sub=2, device=cuda)
    else:
        mesh = synthetic.plane_patch(nx=23, ny=17, lx=6.0, ly=4.0, device=cuda)
    pot = _rand(cuda, torch.float64, 6, mesh.n_vertices, seed=3)
    times = torch.arange(6, dtype=torch.float64, device=cuda) * 0.01
    g, f = build_rhs(mesh, pot, times)
    op = make_operator(mesh, g, 0.01).astype(dtype)
    tiles = assembly.vertex_tiles(op.gather_base, op.dof, op.blocks2, size)
    x, fd = _rand(cuda, dtype, *f.shape, seed=4), f.to(dtype)
    mv = (x, op.dof, op.blocks2, op.g, op.w_scale, op.lambda_, op.gather_base)
    got = _launched("fem_matvec", dtype, lambda: kfem.fem_matvec(*mv, tiles))
    _assert_close([got], [kfem.plain_fem_matvec(*mv)], dtype)
    assert torch.equal(kfem.fem_matvec(*mv, tiles), got)
    got = _launched("fem_matvec", dtype, lambda: kfem.fem_matvec(*mv, tiles, f=fd))
    want = kfem.plain_fem_matvec(*mv, f=fd)
    scale = float(fd.abs().max()) + float(kfem.plain_fem_matvec(*mv).abs().max())
    assert float((got - want).abs().max()) / scale <= TOL[dtype]
    assert torch.equal(kfem.fem_matvec(*mv, tiles, f=fd), got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_frames", [1, 5])
@pytest.mark.parametrize("lam", [0.0, 0.01])
def test_jacobi_blocks_on_a_sphere_patch(cuda, dtype, n_frames, lam):
    """K2 on a sphere patch (valence 5 and 6, padded table rows) at 1 and 5
    frames (no multiple of the frames a thread takes), lambda 0 and 0.01;
    of 5 frames the last has zero a1 factors (every block lambda reg: at
    lambda 0 singular, so the identity). Within TOL of the plain version;
    two calls, and a call on g one element into its storage, bitwise
    equal."""
    mesh = synthetic.sphere_patch(n_sub=2, device=cuda)
    assert bool((mesh.vertex_cells < 0).any())
    pot = _rand(cuda, torch.float64, n_frames + 1, mesh.n_vertices, seed=6)
    times = torch.arange(n_frames + 1, dtype=torch.float64, device=cuda) * 0.01
    g = build_rhs(mesh, pot, times)[0].to(dtype)
    if n_frames > 1:
        g[-1] = 0.0
    reg, areas, base = jacobi_inputs(mesh, dtype)
    jb = (g.contiguous(), reg, areas, lam, base)
    got = _launched("jacobi_blocks", dtype, lambda: kfem.jacobi_blocks(*jb))
    _assert_close([got], [kfem.plain_jacobi_blocks(*jb)], dtype)
    assert _same_bits(kfem.jacobi_blocks(*jb), got)
    # g one element into its storage (off a 16-byte boundary): the same bits.
    odd = torch.empty(g.numel() + 1, dtype=dtype, device=cuda)[1:].view_as(g)
    odd.copy_(g)
    assert _same_bits(kfem.jacobi_blocks(odd, *jb[1:]), got)
    if n_frames > 1 and lam == 0.0:
        assert bool((got[-1] == torch.eye(2, dtype=dtype, device=cuda)).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,size", [("bumpy", 256), ("bumpy", 64), ("plane", 256)])
def test_frame_factors_rhs_is_bitwise_the_ordered_reference(cuda, dtype, shape, size):
    """K4's g and f equal, bit for bit, the reference that keeps its first
    design's order (tests/torch_ordered.py): on the bumpy test mesh (one
    tile of 256 vertices; three of 64, the last ragged) and on a 391-vertex
    plane patch (two tiles, the last of 135), 5 frames (no multiple of the
    frames a block takes), with a next movie of its own; one launch a call,
    two calls bitwise equal."""
    from tests.torch_ordered import ordered_frame_factors_rhs

    if shape == "bumpy":
        mesh, pot, times = _problem(cuda)
    else:
        mesh = synthetic.plane_patch(nx=23, ny=17, lx=6.0, ly=4.0, device=cuda)
        pot = _rand(cuda, torch.float64, 6, mesh.n_vertices, seed=7)
        times = torch.arange(6, dtype=torch.float64, device=cuda) * 0.01
    base = assembly.gather_base_table(mesh)
    args = (pot.to(dtype), pot.flip(0).contiguous().to(dtype), times.to(dtype),
            mesh.triangles, mesh.grad_w.to(dtype), mesh.basis.to(dtype),
            mesh.areas.to(dtype), base)
    tiles = assembly.cell_tiles(base, mesh.n_triangles, size)
    got = _launched("frame_factors_rhs", dtype,
                    lambda: kfem.frame_factors_rhs(*args, tiles))
    want = ordered_frame_factors_rhs(*(a.cpu().numpy() for a in args))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), torch.from_numpy(b))
    again = kfem.frame_factors_rhs(*args, tiles)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def _update_pair(x, r, p, ap, dinv, rz, pap):
    """pcg_update and its plain version on copies of the same state."""
    outs = []
    for fn in (kfem.pcg_update, kfem.plain_pcg_update):
        xs, rs, zs = x.clone(), r.clone(), torch.empty_like(x)
        rz_new, rr = torch.empty_like(rz), torch.empty_like(rz)
        fn(xs, rs, zs, p, ap, dinv, rz, pap, rz_new, rr)
        outs.append((xs, rs, zs, rz_new, rr))
    torch.cuda.synchronize()
    return outs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", [1, 97])
@pytest.mark.parametrize("n", [1, 3, 5, 257, 3136, 12547])
def test_pcg_update_matches_plain_for_any_row_length(cuda, dtype, t, n):
    """K3's update with one block a frame (small n), several (3136, 12547),
    vectors or single elements (n * size a multiple of 16 or not), and
    frames with pAp = 0 (x and r kept); two calls are bitwise equal."""
    x, r, p, ap = (_rand(cuda, dtype, t, 2 * n, seed=20 + k) for k in range(4))
    dinv = _rand(cuda, dtype, t, n, 2, 2, seed=24)
    rz = _rand(cuda, dtype, t, seed=25).abs()
    pap = _rand(cuda, dtype, t, seed=26).abs()
    pap[::3] = 0.0
    before = kernels.LAUNCHES[f"pcg_update<{'float' if dtype == torch.float32 else 'double'}>"]
    got, want = _update_pair(x, r, p, ap, dinv, rz, pap)
    _assert_close(got, want, dtype)
    torch.testing.assert_close(got[0][::3], x[::3], rtol=0, atol=0)
    torch.testing.assert_close(got[1][::3], r[::3], rtol=0, atol=0)
    again, _ = _update_pair(x, r, p, ap, dinv, rz, pap)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ctype = "float" if dtype == torch.float32 else "double"
    assert kernels.LAUNCHES[f"pcg_update<{ctype}>"] == before + 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_pcg_update_on_offset_views(cuda, dtype):
    """Rows off a 16-byte boundary (views with an odd storage offset): all
    five vectors at one offset (vectors with a scalar head and tail) and one
    of them at another (single elements)."""
    t, n = 97, 3136
    bufs = [_rand(cuda, dtype, t * 2 * n + 1, seed=30 + k) for k in range(5)]
    x, r, p, ap = (b[1:].view(t, 2 * n) for b in bufs[:4])
    aligned = bufs[4][:-1].view(t, 2 * n)
    dinv = _rand(cuda, dtype, t, n, 2, 2, seed=35)
    rz, pap = (_rand(cuda, dtype, t, seed=36 + k).abs() for k in range(2))
    for q in (ap, aligned):
        got, want = _update_pair(x, r, p, q, dinv, rz, pap)
        _assert_close(got, want, dtype)
        again, _ = _update_pair(x, r, p, q, dinv, rz, pap)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", DTYPES)
def test_pcg_kernels_match_plain(cuda, dtype):
    gen = torch.Generator().manual_seed(2)
    t, n = 5, 40

    def rand(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64).to(cuda, dtype)
    x, r, p, ap, z = (rand(t, 2 * n) for _ in range(5))
    dinv = rand(t, n, 2, 2)
    rz = rand(t).abs()
    pap = rand(t).abs()
    pap[1] = 0.0  # the zero guard
    got = _launched("pcg_dot", dtype, lambda: kfem.pcg_dot(p, ap))
    _assert_close([got], [kfem.plain_pcg_dot(p, ap)], dtype)

    outs = []
    for fn in (kfem.pcg_update, kfem.plain_pcg_update):
        xs, rs, zs = x.clone(), r.clone(), torch.empty_like(z)
        rz_new, rr = torch.empty_like(rz), torch.empty_like(rz)
        fn(xs, rs, zs, p, ap, dinv, rz, pap, rz_new, rr)
        outs.append((xs, rs, zs, rz_new, rr))
    torch.cuda.synchronize()
    _assert_close(outs[0], outs[1], dtype)
    torch.testing.assert_close(outs[0][0][1], x[1], rtol=0, atol=0)

    rz_old = rz.clone()
    rz_old[2] = 0.0  # the zero guard
    outs = []
    for fn in (kfem.pcg_direction, kfem.plain_pcg_direction):
        q = p.clone()
        fn(q, z, rz, rz_old)
        outs.append((q,))
    _assert_close(outs[0], outs[1], dtype)


def _rand(device, dtype, *shape, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=gen, dtype=torch.float64).to(device, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", [1, 97])
@pytest.mark.parametrize("n", [1, 3, 5, 40, 6273, 40000, 70001])
def test_pcg_dot_matches_plain_for_any_row_length(cuda, dtype, t, n):
    """K3's dot on rows shorter than a vector, with a ragged tail, and
    longer than the 12.5k solve's (25088); two calls are bitwise equal."""
    a, b = _rand(cuda, dtype, t, n, seed=6), _rand(cuda, dtype, t, n, seed=7)
    got = _launched("pcg_dot", dtype, lambda: kfem.pcg_dot(a, b))
    _assert_close([got], [kfem.plain_pcg_dot(a, b)], dtype)
    assert torch.equal(kfem.pcg_dot(a, b), got)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pcg_dot_on_offset_views(cuda, dtype):
    """Rows off a 16-byte boundary: a view with an odd storage offset
    against an aligned operand (the element-wise path) and against a view
    with the same offset (the vector path with a scalar head)."""
    t, n = 97, 6272
    buf_a = _rand(cuda, dtype, t * n + 1, seed=8)
    buf_b = _rand(cuda, dtype, t * n + 1, seed=9)
    a, b = buf_a[1:].view(t, n), buf_b[1:].view(t, n)
    aligned = buf_b[:-1].view(t, n)
    for x, y in ((a, aligned), (a, b), (aligned, a)):
        got = _launched("pcg_dot", dtype, lambda: kfem.pcg_dot(x, y))
        _assert_close([got], [kfem.plain_pcg_dot(x, y)], dtype)
        assert torch.equal(kfem.pcg_dot(x, y), got)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pcg_dot_of_empty_rows_is_zero(cuda, dtype):
    a = torch.empty((4, 0), dtype=dtype, device=cuda)
    got = _launched("pcg_dot", dtype, lambda: kfem.pcg_dot(a, a))
    assert torch.equal(got, torch.zeros(4, dtype=dtype, device=cuda))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shared", [False, True], ids=["per_frame", "shared"])
@pytest.mark.parametrize("nc2", [2, 6, 392, 394])
def test_coarse_gemv_matches_plain_for_any_row_length(cuda, dtype, shared, nc2):
    """K10 with rows of 2 mod 4 values (every other row off a 16-byte
    boundary in float32) and of 0 mod 4, one matrix per frame or one shared
    by every frame (stride 0); two calls are bitwise equal."""
    t = 97
    a = _rand(cuda, dtype, 1 if shared else t, nc2, nc2, seed=10)
    x = _rand(cuda, dtype, t, nc2, seed=11)
    got = _launched("coarse_gemv", dtype, lambda: kco.coarse_gemv(a, x))
    _assert_close([got], [kco.plain_coarse_gemv(a, x)], dtype)
    assert torch.equal(kco.coarse_gemv(a, x), got)


def _aggregation(device, n, seed):
    """A random aggregation of n vertices into max(2, n // 64) aggregates
    of ragged sizes (about 13 to 190 members at 64 on average, so some of
    more and some of fewer than 32 and K past 64): agg (N,) and members
    (Nc, K) ascending, padded with the index N."""
    rng = np.random.default_rng(seed)
    nc = max(2, n // 64)
    weights = rng.uniform(0.2, 3.0, nc)
    agg = rng.choice(nc, size=n, p=weights / weights.sum()).astype(np.int32)
    counts = np.bincount(agg, minlength=nc)
    members = np.full((nc, max(int(counts.max()), 1)), n, dtype=np.int32)
    for a in range(nc):
        span = np.flatnonzero(agg == a)
        members[a, : span.size] = span
    return (torch.from_numpy(agg).to(device), torch.from_numpy(members).to(device))


def _restrict_prolong(r, z, yc, r_blk, agg, members):
    """K9 then K11 and their plain versions on the same inputs: (rc, z, rz)
    of each, the kernels' first."""
    outs = []
    for restrict, prolong in ((kco.coarse_restrict, kco.coarse_prolong_dot),
                              (kco.plain_coarse_restrict, kco.plain_coarse_prolong_dot)):
        zs, rz = z.clone(), torch.empty(z.shape[0], dtype=z.dtype, device=z.device)
        rc = restrict(r, r_blk, members)
        prolong(zs, r, yc, r_blk, agg, rz)
        outs.append((rc, zs, rz))
    torch.cuda.synchronize()
    return outs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", [1, 97])
@pytest.mark.parametrize("n", [5, 257, 3136, 12547])
def test_coarse_restrict_and_prolong_dot_match_plain(cuda, dtype, t, n):
    """K9 and K11 on ragged random aggregations (pad index N, aggregates of
    more and fewer than 32 members), with N * size a multiple of 16 or not,
    one slice a frame or several; each launches once a call and two calls
    are bitwise equal."""
    agg, members = _aggregation(cuda, n, seed=40 + n)
    nc = members.shape[0]
    r_blk = _rand(cuda, dtype, n, 2, 2, seed=41)
    r, z = _rand(cuda, dtype, t, 2 * n, seed=42), _rand(cuda, dtype, t, 2 * n, seed=43)
    yc = _rand(cuda, dtype, t, 2 * nc, seed=44)
    ctype = "float" if dtype == torch.float32 else "double"
    before = {k: kernels.LAUNCHES[f"{k}<{ctype}>"]
              for k in ("coarse_restrict", "coarse_prolong_dot")}
    got, want = _restrict_prolong(r, z, yc, r_blk, agg, members)
    assert all(kernels.LAUNCHES[f"{k}<{ctype}>"] == v + 1 for k, v in before.items())
    _assert_close(got, want, dtype)
    again, _ = _restrict_prolong(r, z, yc, r_blk, agg, members)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", DTYPES)
def test_coarse_restrict_and_prolong_dot_on_offset_views(cuda, dtype):
    """z and r at an odd storage offset: with agg at an offset that keeps
    its groups aligned (K11's vectors with a scalar head and tail), with an
    aligned agg (K11 element by element), and with r_blk off a 16-byte
    boundary (K9's and K11's scalar loads of R_v)."""
    t, n = 97, 3136
    agg, members = _aggregation(cuda, n, seed=50)
    nc = members.shape[0]
    bufs = [_rand(cuda, dtype, t * 2 * n + 1, seed=51 + k) for k in range(2)]
    r, z = (b[1:].view(t, 2 * n) for b in bufs)
    blk = _rand(cuda, dtype, 4 * n + 1, seed=53)
    yc = _rand(cuda, dtype, t, 2 * nc, seed=54)
    agg_buf = torch.empty(n + 1, dtype=torch.int32, device=cuda)
    agg_buf[1:] = agg
    for ids, r_blk in ((agg_buf[1:], blk[:-1].view(n, 2, 2)),
                       (agg, blk[:-1].view(n, 2, 2)),
                       (agg, blk[1:].view(n, 2, 2))):
        got, want = _restrict_prolong(r, z, yc, r_blk, ids, members)
        _assert_close(got, want, dtype)
        again, _ = _restrict_prolong(r, z, yc, r_blk, ids, members)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [257, 12544])
def test_coarse_prolong_dot_z_is_the_plain_update_bit_for_bit(cuda, dtype, n):
    """K11's z is bitwise z + P yc from the plain version. The kernel
    contracts R_v[a, 0] ya + R_v[a, 1] yb into a fused multiply-add, the
    plain version rounds each product, so the inputs are chosen on grids
    where every product and sum is exact: any other entry, index or
    operand shows as a difference."""
    t = 97
    agg, members = _aggregation(cuda, n, seed=60)
    nc = members.shape[0]
    rng = np.random.default_rng(61)

    def grid(shape, steps, scale):
        return torch.from_numpy(rng.integers(-steps, steps + 1, shape) / scale).to(cuda, dtype)
    r_blk, yc = grid((n, 2, 2), 4, 4.0), grid((t, 2 * nc), 8, 8.0)
    z, r = grid((t, 2 * n), 64, 16.0), _rand(cuda, dtype, t, 2 * n, seed=62)
    got, want = _restrict_prolong(r, z, yc, r_blk, agg, members)
    assert torch.equal(got[1], want[1])
    _assert_close(got[2:], want[2:], dtype)


@pytest.mark.parametrize("method", ["cg", "refined", "cholesky"])
def test_solve_on_cuda_matches_cpu(cuda, method):
    mesh, pot, times = _problem(cuda)
    kernels.reset_launches()
    got = compute_velocity_fields(mesh, pot, times, method=method, tol=1e-9)
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES[f"{k}<double>"] > 0
               for k in ("fem_matvec", "frame_factors_rhs", "pcg_dot"))
    want = compute_velocity_fields(mesh.to("cpu"), pot.cpu(), times.cpu(),
                                   method=method, tol=1e-9)
    assert bool(got.converged.all())
    assert abs(got.iterations - want.iterations) <= 2
    err = float((got.v_k.cpu() - want.v_k).abs().max()) / float(want.v_k.abs().max())
    assert err <= 1e-6


def _within_one_ulp(got, want):
    """float32 sums of the precise instances: at most one float32 ulp from
    `want`, the plain float64 sum of the same float32 operands (both are
    float64 sums, in other orders, rounded once)."""
    assert got.dtype == want.dtype == torch.float32
    ulp = torch.from_numpy(np.spacing(want.abs().cpu().numpy())).to(want.device)
    assert bool(((got - want).abs() <= ulp).all())


PRECISE = ("pcg_dot", "pcg_update", "coarse_prolong_dot")


@pytest.mark.parametrize("t", [1, 97])
@pytest.mark.parametrize("n", [1, 5, 257, 3136, 12547])
def test_precise_instances_match_plain(cuda, t, n):
    """K3's dot and update and K11 in their float32 instances with float64
    sums (`<float,double>`) against the precise plain versions: each call
    launches its own instance once and no float instance; every output
    within the float32 tolerance of the plain version's, x, r and z bitwise
    those of the float instance (only the sums change), each sum within one
    float32 ulp of the float64 sum of the kernel's own float32 operands
    (the kernel contracts z = D^-1 r into fused multiply-adds, so its z
    differs from the plain version's in the last bit, and r.z, a sum with
    cancellation, by more), and two calls bitwise equal."""
    def counts():
        return {key: kernels.LAUNCHES[key] for key in (
            f"{k}<{c}>" for k in PRECISE for c in ("float", "float,double"))}
    f32 = torch.float32
    a, b = _rand(cuda, f32, t, 2 * n, seed=60), _rand(cuda, f32, t, 2 * n, seed=61)
    before = counts()
    got = kfem.pcg_dot(a, b, precise=True)
    _within_one_ulp(got, kfem.plain_pcg_dot(a, b, precise=True))
    assert torch.equal(kfem.pcg_dot(a, b, precise=True), got)

    x, r, p, ap = (_rand(cuda, f32, t, 2 * n, seed=62 + k) for k in range(4))
    dinv = _rand(cuda, f32, t, n, 2, 2, seed=66)
    rz, pap = (_rand(cuda, f32, t, seed=67 + k).abs() for k in range(2))
    pap[::3] = 0.0
    outs = []
    for fn, precise in ((kfem.pcg_update, True), (kfem.plain_pcg_update, True),
                        (kfem.pcg_update, True), (kfem.pcg_update, False)):
        xs, rs, zs = x.clone(), r.clone(), torch.empty_like(x)
        rz_new, rr = torch.empty_like(rz), torch.empty_like(rz)
        fn(xs, rs, zs, p, ap, dinv, rz, pap, rz_new, rr, precise)
        outs.append((xs, rs, zs, rz_new, rr))
    torch.cuda.synchronize()
    kernel, plain, again, single = outs
    _assert_close(kernel, plain, f32)
    _within_one_ulp(kernel[3], kfem.plain_pcg_dot(kernel[1], kernel[2], precise=True))
    _within_one_ulp(kernel[4], kfem.plain_pcg_dot(kernel[1], kernel[1], precise=True))
    assert all(torch.equal(u, v) for u, v in zip(kernel, again))
    assert all(torch.equal(u, v) for u, v in zip(kernel[:3], single[:3]))

    agg, members = _aggregation(cuda, n, seed=70 + n)
    r_blk = _rand(cuda, f32, n, 2, 2, seed=71)
    yc = _rand(cuda, f32, t, 2 * members.shape[0], seed=72)
    outs = []
    for fn, precise in ((kco.coarse_prolong_dot, True), (kco.plain_coarse_prolong_dot, True),
                        (kco.coarse_prolong_dot, True), (kco.coarse_prolong_dot, False)):
        zs, rzs = b.clone(), torch.empty(t, dtype=f32, device=cuda)
        fn(zs, a, yc, r_blk, agg, rzs, precise)
        outs.append((zs, rzs))
    torch.cuda.synchronize()
    kernel, plain, again, single = outs
    _assert_close(kernel, plain, f32)
    _within_one_ulp(kernel[1], kfem.plain_pcg_dot(a, kernel[0], precise=True))
    assert all(torch.equal(u, v) for u, v in zip(kernel, again))
    assert torch.equal(kernel[0], single[0])
    after = counts()
    assert {k: after[k] - before[k] for k in after} == {
        "pcg_dot<float>": 0, "pcg_dot<float,double>": 2,
        "pcg_update<float>": 1, "pcg_update<float,double>": 2,
        "coarse_prolong_dot<float>": 1, "coarse_prolong_dot<float,double>": 2}


def test_precise_flag_is_the_double_instance_in_float64(cuda):
    """precise=True on float64 tensors launches the float64 instances, as
    JAX's precise dot is the plain one in float64."""
    a, b = _rand(cuda, torch.float64, 4, 100, seed=80), _rand(cuda, torch.float64, 4, 100, seed=81)
    got = _launched("pcg_dot", torch.float64, lambda: kfem.pcg_dot(a, b, precise=True))
    assert torch.equal(got, kfem.pcg_dot(a, b))


@pytest.mark.parametrize("precond", ["jacobi", "two_level"])
def test_precise_cg_solve_on_cuda_matches_cpu(cuda, precond):
    """A float32 cg solve with precise_dots on the card: only the precise
    instances of K3's dot and update (and of K11 under two-level) launch,
    and the result agrees with the CPU's plain versions."""
    _, pot, times = _problem(cuda)
    mesh32 = synthetic.plane_patch(
        nx=12, ny=12, lx=6.0, ly=6.0, device=cuda, dtype=np.float32,
        height=lambda x, y: 0.8 * np.exp(-((x - 3.0) ** 2 + (y - 3.0) ** 2) / 4.0))
    kw = dict(method="cg", tol=1e-5, precond=precond, precise_dots=True)
    kernels.reset_launches()
    got = compute_velocity_fields(mesh32, pot.float(), times.float(), **kw)
    torch.cuda.synchronize()
    launched = dict(kernels.LAUNCHES)
    assert launched["pcg_dot<float,double>"] > 0 and launched["pcg_update<float,double>"] > 0
    assert launched["pcg_dot<float>"] == launched["pcg_update<float>"] == 0
    assert (launched["coarse_prolong_dot<float,double>"] > 0) == (precond == "two_level")
    assert launched["coarse_prolong_dot<float>"] == 0
    want = compute_velocity_fields(mesh32.to("cpu"), pot.float().cpu(), times.float().cpu(), **kw)
    assert bool(got.converged.all())
    assert abs(got.iterations - want.iterations) <= 2
    err = float((got.v_k.cpu() - want.v_k).abs().max()) / float(want.v_k.abs().max())
    assert err <= 1e-3


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("a1_mode", ["full", "mean"])
def test_coarse_kernels_match_plain(cuda, dtype, a1_mode):
    mesh, pot, times = _problem(cuda)
    g, _ = build_rhs(mesh, pot, times)
    op = make_operator(mesh, g, 0.01).astype(dtype)
    tables = coarse.build_tables(mesh, passes=1)
    r_blk = coarse.prolongation_blocks(mesh, tables, dtype)
    args = (op.g, op.blocks2, r_blk, mesh.triangles, mesh.areas.to(dtype) / 12.0,
            op.lambda_, tables.asm_ptr, tables.asm_src, tables.asm_dst,
            tables.n_coarse, a1_mode == "mean")
    got = _launched("coarse_assemble", dtype, lambda: kco.coarse_assemble(*args))
    _assert_close([got], [kco.plain_coarse_assemble(*args)], dtype)

    pre = coarse.make_two_level(mesh, op.g, op.lambda_, tables, a1_mode=a1_mode)
    gen = torch.Generator().manual_seed(4)
    r, z = (torch.randn((g.shape[0], mesh.n_dof), generator=gen,
                        dtype=torch.float64).to(cuda, dtype) for _ in range(2))
    rc = _launched("coarse_restrict", dtype,
                   lambda: kco.coarse_restrict(r, pre.r_blk, pre.members))
    _assert_close([rc], [kco.plain_coarse_restrict(r, pre.r_blk, pre.members)], dtype)
    yc = _launched("coarse_gemv", dtype, lambda: kco.coarse_gemv(pre.ac_inv, rc))
    _assert_close([yc], [kco.plain_coarse_gemv(pre.ac_inv, rc)], dtype)
    outs = []
    for fn in (kco.coarse_prolong_dot, kco.plain_coarse_prolong_dot):
        zs, rz = z.clone(), torch.empty(g.shape[0], dtype=dtype, device=cuda)
        fn(zs, r, yc, pre.r_blk, pre.agg, rz)
        outs.append((zs, rz))
    torch.cuda.synchronize()
    _assert_close(outs[0], outs[1], dtype)


ENTRY_SIZES = (1, 31, 32, 33)


def _ragged_assembly(device, dtype, t, seed):
    """coarse_assemble's inputs on random tables in sibling pairs whose first
    entries list 1, 31, 32 and 33 even contributions in turn (fewer, as many
    and more than a warp's lanes), each ascending, and whose second entries
    list the same plus one. The pairs target distinct random slots (2b,
    2b + 1) of a row of a (24, 24) coarse matrix."""
    rng = np.random.default_rng(seed)
    m, n, n_coarse = 40, 30, 12
    triangles = np.stack([rng.choice(n, 3, replace=False) for _ in range(m)])
    even = rng.permutation(np.arange(0, 36 * m, 2))
    lists, k, i = [], 0, 0
    while k < even.size:
        chunk = np.sort(even[k:k + ENTRY_SIZES[i % 4]])
        k += chunk.size
        lists += [chunk, chunk + 1]
        i += 1
    ptr = np.concatenate([[0], np.cumsum([len(x) for x in lists])])
    src = np.concatenate(lists)
    first = 2 * rng.choice((2 * n_coarse) ** 2 // 2, len(lists) // 2, replace=False)
    dst = np.stack([first, first + 1], axis=1).reshape(-1)
    coarse.check_sibling_pairs(ptr, src, dst)

    def arr(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, dt)
    return (_rand(device, dtype, t, m, 3, 2, seed=seed + 1),
            _rand(device, dtype, m, 6, 6, seed=seed + 2),
            _rand(device, dtype, n, 2, 2, seed=seed + 3), arr(triangles, torch.int32),
            _rand(device, dtype, m, seed=seed + 4).abs(), 0.01, arr(ptr, torch.int32),
            arr(src, torch.int32), arr(dst, torch.int32), n_coarse)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", [1, 3, 97])
@pytest.mark.parametrize("mean", [False, True], ids=["full", "mean"])
def test_coarse_assemble_matches_plain_on_ragged_entries(cuda, dtype, t, mean):
    """K8 with sibling pairs of entries of 1, 31, 32 and 33 contributions,
    frame counts that are no multiple of its frames a warp, and in
    'mean' mode: one launch a call, within TOL of the plain version, two
    calls bitwise equal."""
    args = _ragged_assembly(cuda, dtype, t, seed=50 + t)
    got = _launched("coarse_assemble", dtype,
                    lambda: kco.coarse_assemble(*args, mean=mean))
    assert got.shape == (1 if mean else t, 24, 24)
    _assert_close([got], [kco.plain_coarse_assemble(*args, mean=mean)], dtype)
    assert torch.equal(kco.coarse_assemble(*args, mean=mean), got)


@pytest.mark.parametrize("method", ["cg", "refined"])
def test_two_level_solve_on_cuda_matches_cpu(cuda, method):
    mesh, pot, times = _problem(cuda)
    kw = dict(method=method, tol=1e-9, precond="two_level", coarse_passes=1)
    kernels.reset_launches()
    got = compute_velocity_fields(mesh, pot, times, **kw)
    torch.cuda.synchronize()
    ctype = "double" if method == "cg" else "float"
    assert all(kernels.LAUNCHES[f"{k}<{ctype}>"] > 0 for k in (
        "coarse_assemble", "coarse_restrict", "coarse_gemv", "coarse_prolong_dot"))
    want = compute_velocity_fields(mesh.to("cpu"), pot.cpu(), times.cpu(), **kw)
    assert bool(got.converged.all())
    assert abs(got.iterations - want.iterations) <= 2
    err = float((got.v_k.cpu() - want.v_k).abs().max()) / float(want.v_k.abs().max())
    assert err <= 1e-6


def test_auto_is_refined_on_cuda(cuda):
    mesh, pot, times = _problem(cuda)
    kernels.reset_launches()
    compute_velocity_fields(mesh, pot, times, method="auto", tol=1e-9)
    assert kernels.LAUNCHES["fem_matvec<float>"] > 0


def _flow_problem(device):
    """A generic (bumpy) surface: on a symmetric one the field's zeros sit on
    edges and vertices and detections flip on last-ulp differences."""
    mesh = synthetic.plane_patch(
        nx=16, ny=16, lx=10.0, ly=10.0, device=device,
        height=lambda x, y: 0.3 * np.sin(0.9 * x) * np.cos(0.7 * y))
    pot, times, _ = synthetic.two_source_movie(mesh, n_frames=5)
    return mesh, pot, times


def _assert_same(got, want, dtype):
    """Integer and bool outputs equal; floats within TOL of the largest
    finite entry, NaNs (the all-zero frame) in the same places."""
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if not a.is_floating_point():
            assert torch.equal(a, b)
            continue
        finite = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), finite) and finite.any()
        scale = max(float(b[finite].abs().max()), 1e-300)
        assert float((a[finite] - b[finite]).abs().max()) <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", DTYPES)
def test_analysis_kernels_match_plain(cuda, dtype):
    mesh, pot, times = _flow_problem(cuda)
    v_k = compute_velocity_fields(mesh, pot, times, method="cg", tol=1e-10).v_k
    v_k = torch.cat([v_k, torch.zeros_like(v_k[:1])]).to(dtype)  # + a zero frame
    basis, points = mesh.basis.to(dtype), mesh.points.to(dtype)
    got = _launched("recombine_speed", dtype, lambda: kan.recombine_speed(v_k, basis))
    want = kan.plain_recombine_speed(v_k, basis)
    _assert_same(got, want, dtype)
    assert float(got[2][-1]) == 0.0

    args = (points, mesh.triangles, *want, 1e-4)
    got = _launched("detect_singular", dtype, lambda: kan.detect_singular(*args))
    want = kan.plain_detect_singular(*args)
    _assert_same(got, want, dtype)
    vertex_mask, interior_mask, _, interior_point, counts = want
    assert int(counts[:-1, 1].min()) > 0 and int(counts[-1].abs().sum()) == 0

    for cap in (8, sing.capacity_for(*counts.amax(dim=0).tolist())):
        args = (vertex_mask, interior_mask, interior_point, points, cap)
        got = _launched("compact_detected", dtype, lambda: kan.compact_detected(*args))
        _assert_same(got, kan.plain_compact_detected(*args), dtype)


def _cycled(v_world, n_frames):
    """n_frames world velocity frames cycled from v_world, each scaled by its
    own factor, the last one all zero (v_max = 0) where n_frames > 1; with
    their speeds and v_max."""
    k = torch.arange(n_frames, device=v_world.device)
    out = v_world[k % v_world.shape[0]] * (1.0 + 0.25 * k).to(v_world.dtype)[:, None, None]
    if n_frames > 1:
        out[-1] = 0.0
    speed = kan.plain_speed(out)
    return out.contiguous(), speed, speed.amax(dim=-1)


# K6 takes 4 frames a thread, K13 4 or 8: frame counts at and around both.
GROUP_EDGES = [1, 3, 4, 5, 7, 8, 9, 98]


@pytest.mark.parametrize("n_frames", GROUP_EDGES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_detect_singular_at_frame_group_edges(cuda, dtype, n_frames):
    """K6 against its plain version where its frame groups have edges, on
    452 triangles (no whole number of 128-thread blocks), two of them
    degenerate (|n| = 0), and a last all-zero frame: every output bit for
    bit the plain version's, which rounds each operation on its own too."""
    mesh, v_world, _, _ = _velocity_field(cuda, dtype)
    v, speed, v_max = _cycled(v_world, n_frames)
    tris = torch.cat([mesh.triangles, torch.tensor([[0, 0, 1], [5, 6, 5]], dtype=torch.int32,
                                                   device=cuda)])
    args = (mesh.points.to(dtype), tris, v, speed, v_max, 1e-4)
    got = _launched("detect_singular", dtype, lambda: kan.detect_singular(*args))
    want = kan.plain_detect_singular(*args)
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    assert int(got[4][0, 1]) > 0
    if n_frames > 1:
        assert got[4][-1].tolist() == [0, 0]


@pytest.mark.parametrize("dtype", DTYPES)
def test_detect_singular_over_every_exponent(cuda, dtype):
    """K6 on velocities that span the dtype's exponents (each vertex scaled
    by 2^k, k random over most of the range, some components exactly 0),
    frames with tiny and huge v_max: every output bit for bit the plain
    version's, so every quotient is the correctly rounded one whichever
    way the kernel forms it."""
    mesh, v_world, _, _ = _velocity_field(cuda, dtype)
    gen = np.random.default_rng(7)
    top = 120 if dtype == torch.float32 else 1000
    t, n = 12, mesh.n_vertices
    base = v_world[np.arange(t) % v_world.shape[0]].clone()
    vert_exp = gen.integers(-top, top // 2, size=(t, n, 1))
    frame_exp = gen.integers(-top // 2, top // 2, size=(t, 1, 1))
    scale = torch.as_tensor(np.exp2((vert_exp + frame_exp).astype(np.float64)),
                            device=cuda).to(dtype)
    v = base * scale
    v[torch.as_tensor(gen.random((t, n, 3)) < 0.05, device=cuda)] = 0.0
    v[3] = base[3]  # one frame as solved
    v = v.contiguous()
    speed = kan.plain_speed(v)
    args = (mesh.points.to(dtype), mesh.triangles, v, speed, speed.amax(dim=-1), 1e-4)
    got = _launched("detect_singular", dtype, lambda: kan.detect_singular(*args))
    want = kan.plain_detect_singular(*args)
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    assert int(got[4][3, 1]) > 0


def _fan(device, spokes):
    """A fan of `spokes` triangles around vertex 0 (a 1-ring of `spokes`
    neighbours; every rim vertex a boundary vertex of 3 neighbours), on a
    bumped cone."""
    from manifold_flow_tpu_torch.geometry.mesh import build_mesh

    ang = 2.0 * np.pi * np.arange(spokes) / spokes
    rim = np.stack([np.cos(ang), 0.8 * np.sin(ang), 0.3 + 0.1 * np.cos(3.0 * ang)], axis=-1)
    points = np.concatenate([np.zeros((1, 3)), rim])
    k = np.arange(spokes)
    tris = np.stack([np.zeros(spokes, dtype=np.int64), 1 + k, 1 + (k + 1) % spokes], axis=-1)
    return build_mesh(points, tris, dtype=np.float64, device=device)


@pytest.mark.parametrize("n_frames", GROUP_EDGES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_next_hop_at_frame_group_edges(cuda, dtype, n_frames):
    """K13 against its plain version where its frame groups have edges, in
    both quirk modes, on a patch with padded 1-rings and boundary slots
    that share one cell (tested) and two (advance), a velocity row of NaNs
    (argmax takes the NaN: no hop) and a last all-zero frame."""
    mesh, v_world, _, _ = _velocity_field(cuda, dtype)
    v, _, _ = _cycled(v_world, n_frames)
    v[0, 7, 1] = float("nan")
    unit = stream.unit_edges(mesh, dtype)
    assert bool((mesh.vertex_neighbors == -1).any())
    for quirks in (False, True):
        rules, corners = stream.hop_tables(mesh, dtype, quirks)
        boundary = mesh.vertex_cell_count < 6
        assert bool((rules[boundary] >= 0).any()) and bool(
            (rules[boundary] == kst.HOP_ADVANCE).any())
        args = (unit, v, mesh.vertex_neighbors, rules, corners, mesh.basis.to(dtype))
        hops = _launched("next_hop", dtype, lambda: kst.next_hop(*args))
        assert torch.equal(hops, kst.plain_next_hop(*args))
        assert int(hops[0, 7]) == 7
        ids = torch.arange(mesh.n_vertices, device=cuda)
        assert bool((hops[0] != ids).any())
        if n_frames > 1:
            assert bool((hops[-1] == ids).all())


@pytest.mark.parametrize("n_frames", [7, 8, 9, 17])
def test_next_hop_at_frame_group_edges_of_eight(cuda, n_frames):
    """K13 where it takes 8 frames a thread: on a 260 x 260 patch (67600
    vertices, 529 blocks of 128 for each group of 8 frames, 4 an SM on a
    132-SM card) around the edges of its groups of 8, random velocities
    with a last all-zero frame, both quirk modes: next equal to the plain
    version's."""
    mesh = synthetic.plane_patch(
        nx=260, ny=260, lx=60.0, ly=60.0, device=cuda,
        height=lambda x, y: 6.0 * np.sin(x / 12.0) * np.cos(y / 15.0))
    gen = np.random.default_rng(n_frames)
    v = torch.as_tensor(gen.standard_normal((n_frames, mesh.n_vertices, 3)), device=cuda)
    v[-1] = 0.0
    for quirks in (False, True):
        args = (stream.unit_edges(mesh, torch.float64), v, mesh.vertex_neighbors,
                *stream.hop_tables(mesh, torch.float64, quirks), mesh.basis)
        hops = _launched("next_hop", torch.float64, lambda: kst.next_hop(*args))
        assert torch.equal(hops, kst.plain_next_hop(*args))
        assert bool((hops[-1] == torch.arange(mesh.n_vertices, device=cuda)).all())


@pytest.mark.parametrize("spokes", [8, 14])
@pytest.mark.parametrize("dtype", DTYPES)
def test_next_hop_on_wide_one_rings(cuda, dtype, spokes):
    """K13 where the 1-ring is wider than the slots held in registers (8
    and 14 neighbours at the fan's hub): next equal to the plain version's
    over 9 random frames, in both quirk modes."""
    mesh = _fan(cuda, spokes)
    assert mesh.vertex_neighbors.shape[1] == spokes
    gen = np.random.default_rng(spokes)
    v = torch.as_tensor(gen.standard_normal((9, mesh.n_vertices, 3)), device=cuda).to(dtype)
    for quirks in (False, True):
        args = (stream.unit_edges(mesh, dtype), v, mesh.vertex_neighbors,
                *stream.hop_tables(mesh, dtype, quirks), mesh.basis.to(dtype))
        hops = _launched("next_hop", dtype, lambda: kst.next_hop(*args))
        assert torch.equal(hops, kst.plain_next_hop(*args))
        assert bool((hops[:, 0] != 0).any())


def _same_bits(a, b):
    """Equal bit for bit: floats by their bits (NaNs included)."""
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.is_floating_point():
        ints = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
        return torch.equal(a.view(ints), b.view(ints))
    return torch.equal(a, b)


# K7 inputs built to break it: (frames, grid columns x rows of the flat
# vertex grid, triangles M, capacity, share of masked vertices, share of
# masked triangles, what the queries are).
COMPACT_CASES = {
    "ties": (4, (40, 30), 2400, 16, 0.01, 0.01, "ties"),
    "nan_frame": (3, (40, 30), 2400, 16, 0.01, 0.01, "nan"),
    "no_detections": (3, (40, 30), 2400, 16, 0.0, 0.0, "random"),
    "capacity_1": (3, (40, 30), 2400, 1, 0.01, 0.01, "ties"),
    "truncated": (3, (40, 30), 2400, 8, 0.2, 0.2, "random"),
    "capacity_n": (2, (20, 15), 700, 300, 0.3, 0.3, "ties"),
    "n_ragged": (3, (61, 49), 5000, 16, 0.01, 0.01, "random"),
    "n_60000": (2, (300, 200), 60013, 16, 0.001, 0.001, "ties"),
    "t_1": (1, (40, 30), 2400, 16, 0.01, 0.01, "ties"),
    "t_300": (300, (20, 15), 551, 16, 0.02, 0.02, "ties"),
}


def _compact_inputs(device, dtype, case):
    """K7's inputs for COMPACT_CASES[case]: vertices on a flat unit grid
    (exact coordinates), random masks, and interior points at edge
    midpoints and cell centers (two or four vertices at one distance), at
    random places, or NaN in every point of the last frame (a frame with
    v_max = 0)."""
    t, (nx, ny), m, cap, p_v, p_i, queries = COMPACT_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    gx, gy = np.meshgrid(np.arange(nx, dtype=np.float64), np.arange(ny, dtype=np.float64))
    points = np.stack([gx.ravel(), gy.ravel(), np.zeros(nx * ny)], axis=-1)
    vmask = rng.random((t, nx * ny)) < p_v
    imask = rng.random((t, m)) < p_i
    if queries == "random":
        ipoint = rng.uniform(-1.0, [nx, ny, 1.0], (t, m, 3))
    else:
        ipoint = np.stack([rng.integers(0, nx - 1, (t, m)).astype(np.float64),
                           rng.integers(0, ny - 1, (t, m)).astype(np.float64),
                           np.zeros((t, m))], axis=-1)
        ipoint[..., 0] += 0.5                                   # an edge midpoint
        ipoint[..., 1] += 0.5 * (rng.random((t, m)) < 0.5)      # or a cell center
    if queries == "nan":
        ipoint[-1] = np.nan
        imask[-1] = vmask[-1] = False
    as_t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)  # noqa: E731
    return (as_t(vmask, torch.bool), as_t(imask, torch.bool), as_t(ipoint, dtype),
            as_t(points, dtype), cap)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(COMPACT_CASES))
def test_compact_detected_matches_plain_on_edge_cases(cuda, dtype, case):
    """K7 (compaction, then the snap in groups of slots over tiles of
    vertices) against its plain version: ids, valid flags, points and
    centers equal, bit for bit; ties go to the lower index and NaN queries
    to vertex 0, as torch.argmin gives them."""
    args = _compact_inputs(cuda, dtype, case)
    got = _launched("compact_detected", dtype, lambda: kan.compact_detected(*args))
    want = kan.plain_compact_detected(*args)
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    vmask, imask, _, points, cap = args
    assert got[0].shape == (vmask.shape[0], min(cap, vmask.shape[1]))
    if COMPACT_CASES[case][-1] == "ties":  # the lowest of the nearest vertices
        nx = COMPACT_CASES[case][1][0]
        corner = got[4].floor().long()
        assert torch.equal(got[5].long(), corner[..., 1] * nx + corner[..., 0])
    if case == "nan_frame":
        assert bool((got[5][-1] == 0).all()) and bool(got[4][-1].isnan().all())
    if case == "truncated":
        assert bool(got[1].all()) and bool(got[3].all())
    if case == "no_detections":
        assert not bool(got[1].any()) and not bool(got[3].any())
        assert torch.equal(got[2][0].long(), torch.arange(cap, device=cuda))


@pytest.mark.parametrize("max_steps", [16, 64, 256])
def test_trace_walks_around_the_cap(cuda, max_steps):
    """Walks with mu + lambda of cap - 1, cap and cap + 1 (cap =
    max_steps + 1): the lengths equal the plain version's."""
    cap = max_steps + 1
    hops = torch.from_numpy(around_the_cap(max_steps, seed=max_steps)).to(cuda)
    lengths = _launched("trace_walks", None, lambda: kst.trace_walks(hops, max_steps))
    assert torch.equal(lengths, kst.plain_trace_walks(hops, max_steps))
    assert {cap - 1, cap} <= set(lengths.flatten().tolist())


def test_trace_walks_past_shared_memory(cuda):
    """A row of 60000 vertices, past the shared memory a block may hold:
    the walks read it from device memory."""
    rng = np.random.default_rng(11)
    n = 60000
    hops = rng.integers(0, n, (2, n), dtype=np.int32)
    hops[0, :n // 2] = np.arange(1, n // 2 + 1)             # a long path
    hops[1] = np.roll(np.arange(n, dtype=np.int32), 1)       # one 60000-cycle
    hops = torch.from_numpy(hops).to(cuda)
    for max_steps in (16, 256):
        lengths = _launched("trace_walks", None, lambda: kst.trace_walks(hops, max_steps))
        assert torch.equal(lengths, kst.plain_trace_walks(hops, max_steps))
    assert bool((lengths[1] == 257).all()) and int(lengths[0].min()) < 257


def test_flow_stage_on_cuda_matches_cpu(cuda):
    mesh, pot, times = _flow_problem(cuda)
    cfg = PipelineConfig()
    cfg.solver.tol = 1e-10
    cfg.solver.method = "refined"
    runs = []
    for m, p, t in ((mesh, pot, times), (mesh.to("cpu"), pot.cpu(), times.cpu())):
        kernels.reset_launches()
        vel = stages.velocity_stage(m, p, t, cfg)
        pts, _, centers = stages.singularity_stage(
            m, vel.v_world, cfg, speed=vel.speed, v_max=vel.v_max,
            return_centers=True)
        runs.append((vel, pts, centers, dict(kernels.LAUNCHES)))
    (vel, pts, centers, launches), (vel_c, pts_c, centers_c, launches_c) = runs
    assert all(launches[f"{k}<double>"] > 0 for k in (
        "recombine_speed", "detect_singular", "compact_detected", "fem_matvec"))
    assert set(launches_c.values()) == {0}
    assert vel.converged and vel_c.converged
    for a, b in ((vel.v_k, vel_c.v_k), (vel.v_world, vel_c.v_world),
                 (vel.speed, vel_c.speed)):
        assert float((a.cpu() - b).abs().max()) <= 1e-8 * float(b.abs().max())
    assert [len(p) for p in pts] == [len(p) for p in pts_c]
    assert sum(len(p) for p in pts) > 0
    for a, b, ca, cb in zip(pts, pts_c, centers, centers_c):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8)
        np.testing.assert_array_equal(ca, cb)


def test_public_ops_on_cuda_raise_or_launch(cuda):
    """Each public op of the flow stage, given CUDA tensors, launches its
    counted kernel or raises: none runs a plain version on the card. The
    counts that size the compaction are K6's own."""
    mesh, pot, times = _flow_problem(cuda)
    v_k = compute_velocity_fields(mesh, pot, times, method="cg", tol=1e-10).v_k

    def launched():
        torch.cuda.synchronize()
        out = {k: v for k, v in kernels.LAUNCHES.items() if v}
        kernels.reset_launches()
        return out

    kernels.reset_launches()
    v_world = recombine.velocity_to_world(v_k, mesh.basis)
    assert launched() == {"recombine_speed<double>": 1}
    v_world, speed, v_max = recombine.velocity_to_world_and_speed(v_k, mesh.basis)
    assert launched() == {"recombine_speed<double>": 1}
    with pytest.raises(ValueError, match="velocity_to_world_and_speed"):
        recombine.world_speed(v_world)
    with pytest.raises(ValueError, match="velocity_to_world_and_speed"):
        sing.detect(mesh, v_world)
    assert launched() == {}
    field, counts = sing.detect_with_counts(mesh, v_world, speed=speed,
                                            v_max=v_max)
    assert launched() == {"detect_singular<double>": 1}
    assert torch.equal(counts, field.counts.amax(dim=0))
    assert [int(c) for c in sing.detection_counts(field)] == counts.tolist()
    cap = sing.compact_capacity(field)
    assert cap == sing.capacity_for(*counts.tolist()) and launched() == {}
    rows = sing.compact_all(mesh, field, with_centers=True)
    assert launched() == {"compact_detected<double>": 1}
    assert len(rows) == v_k.shape[0] and sum(len(r[2]) for r in rows) > 0
    sing.compact_detected(mesh, field, capacity=cap)
    assert launched() == {"compact_detected<double>": 1}

    # The two-level preconditioner: K8 builds it, K9-K11 apply it (after
    # K3's Jacobi term); the inverse is torch.linalg's.
    g, f = build_rhs(mesh, pot, times)
    launched()
    pre = coarse.make_two_level(mesh, g, 0.01, coarse.build_tables(mesh, passes=1))
    assert launched() == {"jacobi_blocks<double>": 1, "coarse_assemble<double>": 1}
    z = pre.apply(f)
    assert launched() == {"pcg_update<double>": 1, "coarse_restrict<double>": 1,
                          "coarse_gemv<double>": 1, "coarse_prolong_dot<double>": 1}
    assert bool(torch.isfinite(z).all()) and not bool(pre.zeroed.any())


QUIRKS = pytest.mark.parametrize("quirks", [False, True], ids=["quirks_off", "quirks_on"])


def _velocity_field(device, dtype):
    """The flow problem's world velocity field in `dtype`, its speed and
    v_max (K5's plain version)."""
    mesh, pot, times = _flow_problem(device)
    v_k = compute_velocity_fields(mesh, pot, times, method="cg", tol=1e-10).v_k
    return mesh, *kan.plain_recombine_speed(v_k.to(dtype), mesh.basis.to(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@QUIRKS
def test_classify_kernel_matches_plain(cuda, dtype, quirks):
    mesh, v_world, speed, v_max = _velocity_field(cuda, dtype)
    field, counts = sing.detect_with_counts(mesh, v_world, speed=speed, v_max=v_max)
    # 8 slots past the largest count: every frame has invalid slots too.
    det = sing.compact_detected(mesh, field,
                                capacity=sing.capacity_for(*counts.tolist()) + 8)
    assert bool(det.interior_valid.any()) and bool((~det.interior_valid).any())
    head = (mesh.points.to(dtype), mesh.basis.to(dtype), mesh.vertex_neighbors,
            mesh.triangles, topology.cells_across_edges(mesh), v_world, v_max)
    t = v_world.shape[0]
    every_v = torch.arange(mesh.n_vertices, dtype=torch.int32, device=cuda).expand(t, -1)
    every_i = torch.arange(mesh.n_triangles, dtype=torch.int32, device=cuda).expand(t, -1)
    for slots in ((det.vertex_ids, det.vertex_valid, det.interior_ids,
                   det.interior_valid, det.interior_points),
                  (every_v.contiguous(), torch.ones_like(every_v, dtype=torch.bool),
                   every_i.contiguous(), torch.ones_like(every_i, dtype=torch.bool),
                   field.interior_point)):
        args = head + slots
        got = _launched("classify_candidates", dtype,
                        lambda: kan.classify_candidates(*args, quirks=quirks))
        want = kan.plain_classify_candidates(*args, quirks=quirks)
        _assert_same(got, want, dtype)
    codes = torch.cat([got[0].flatten(), got[2].flatten()])
    assert len(set(codes.tolist())) >= 3


def _fan_slots(mesh, case, n_frames, seed):
    """K12's candidate slots on `mesh` for each frame: every vertex and every
    triangle (an interior point at random barycentric weights inside it),
    in random order with random valid flags, the caps 1 and 3 slots past
    the mesh's counts (no multiple of the slots a block takes). Cases:
    "full", "no_vertex" (S_v = 0), "no_interior" (S_i = 0), "invalid"
    (every slot invalid)."""
    gen = np.random.default_rng(seed)
    n, m = mesh.n_vertices, mesh.n_triangles
    vid = np.stack([gen.permutation(np.resize(np.arange(n), n + 1)) for _ in range(n_frames)])
    iid = np.stack([gen.permutation(np.resize(np.arange(m), m + 3)) for _ in range(n_frames)])
    w = gen.dirichlet((1.0, 1.0, 1.0), size=iid.shape)
    corners = mesh.points.cpu().numpy()[mesh.triangles.cpu().numpy()[iid]]
    ipt = np.einsum("tsc,tscd->tsd", w, corners)
    vok, iok = gen.random(vid.shape) < 0.8, gen.random(iid.shape) < 0.8
    if case == "invalid":
        vok[:], iok[:] = False, False
    if case == "no_vertex":
        vid, vok = vid[:, :0], vok[:, :0]
    if case == "no_interior":
        iid, iok, ipt = iid[:, :0], iok[:, :0], ipt[:, :0]
    dev = mesh.points.device
    return (torch.as_tensor(vid, dtype=torch.int32, device=dev).contiguous(),
            torch.as_tensor(vok, device=dev).contiguous(),
            torch.as_tensor(iid, dtype=torch.int32, device=dev).contiguous(),
            torch.as_tensor(iok, device=dev).contiguous(),
            torch.as_tensor(ipt, device=dev).contiguous())


@pytest.mark.parametrize("case", ["full", "no_vertex", "no_interior", "invalid"])
@pytest.mark.parametrize("spokes", [8, 14])
@pytest.mark.parametrize("dtype", DTYPES)
@QUIRKS
def test_classify_kernel_on_fans(cuda, dtype, quirks, spokes, case):
    """K12 on the fans of 8 and 14 spokes (the hub's 1-ring is one or two
    rounds of a slot's lanes; rim triangles have boundary edges), 9 random
    frames, every vertex and triangle as a slot: codes and Jacobians bitwise
    the plain version's."""
    mesh = _fan(cuda, spokes)
    gen = np.random.default_rng(spokes)
    v = torch.as_tensor(gen.standard_normal((9, mesh.n_vertices, 3)), device=cuda).to(dtype)
    v_max = kan.plain_speed(v).amax(dim=-1).contiguous()
    slots = _fan_slots(mesh, case, 9, seed=spokes)
    args = (mesh.points.to(dtype), mesh.basis.to(dtype), mesh.vertex_neighbors,
            mesh.triangles, topology.cells_across_edges(mesh), v, v_max, *slots[:4],
            slots[4].to(dtype).contiguous())
    got = _launched("classify_candidates", dtype,
                    lambda: kan.classify_candidates(*args, quirks=quirks))
    want = kan.plain_classify_candidates(*args, quirks=quirks)
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    if case == "invalid":
        assert bool((got[0] == sing.INDETERMINATE).all() and (got[2] == sing.INDETERMINATE).all())
    elif case == "full":
        assert len(set(torch.cat([got[0].flatten(), got[2].flatten()]).tolist())) >= 3


@pytest.mark.parametrize("dtype", DTYPES)
@QUIRKS
def test_stream_kernels_match_plain(cuda, dtype, quirks):
    mesh, v_world, _, _ = _velocity_field(cuda, dtype)
    v_world = torch.cat([v_world, torch.zeros_like(v_world[:1])])  # a halting frame
    args = (stream.unit_edges(mesh, dtype), v_world, mesh.vertex_neighbors,
            *stream.hop_tables(mesh, dtype, quirks), mesh.basis.to(dtype))
    hops = _launched("next_hop", dtype, lambda: kst.next_hop(*args))
    assert torch.equal(hops, kst.plain_next_hop(*args))
    ids = torch.arange(mesh.n_vertices, device=cuda)
    assert bool((hops[-1] == ids).all()) and bool((hops[:-1] != ids).any())
    for max_steps in (3, 64):
        lengths = _launched("trace_walks", None, lambda: kst.trace_walks(hops, max_steps))
        assert torch.equal(lengths, kst.plain_trace_walks(hops, max_steps))
    assert int(lengths.max()) > 4


def _pack_pair(hops, seeds, lens, offsets, size, fill=-7):
    """pack_walks and its plain version into two buffers of `size` ids
    prefilled with `fill`; the kernel's launch is checked."""
    outs = [torch.full((size,), fill, dtype=torch.int32, device=hops.device)
            for _ in range(2)]
    _launched("pack_walks", None,
              lambda: kst.pack_walks(hops, seeds, lens, offsets, outs[0]))
    kst.plain_pack_walks(hops, seeds, lens, offsets, outs[1])
    torch.cuda.synchronize()
    return outs


def _packed(lens):
    """Offsets of walks back to back (an exclusive cumsum) and their total."""
    offsets = torch.cumsum(lens, 0, dtype=torch.int64) - lens
    return offsets, int(lens.sum())


def test_walk_kernels_match_plain_on_random_graphs(cuda):
    """Random functional graphs: long tails and cycles, walks past the cap;
    the kept walks packed back to back and every walk in its row of
    max_steps + 1 ids, as trace_frames lays them out."""
    gen = torch.Generator().manual_seed(3)
    hops = torch.randint(0, 3000, (3, 3000), generator=gen, dtype=torch.int32)
    hops[1] = torch.roll(torch.arange(3000, dtype=torch.int32), 1)  # one 3000-cycle
    hops = hops.to(cuda)
    for max_steps in (0, 16, 256):
        lengths = _launched("trace_walks", None, lambda: kst.trace_walks(hops, max_steps))
        want = kst.plain_trace_walks(hops, max_steps)
        assert torch.equal(lengths, want)
    assert bool((lengths[1] == 257).all()) and int(lengths[0].min()) < 257
    flat = lengths.reshape(-1)
    for min_length in (1, 40):
        seeds = torch.nonzero(flat >= min_length)[:, 0]
        lens = flat[seeds].contiguous()
        offsets, total = _packed(lens)
        outs = _pack_pair(hops, seeds, lens, offsets, total + 5)
        assert torch.equal(outs[0], outs[1]) and bool((outs[0][-5:] == -7).all())
    seeds = torch.arange(flat.numel(), device=cuda)
    outs = _pack_pair(hops, seeds, flat.contiguous(), seeds * 257, flat.numel() * 257,
                      fill=-1)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("layout", ["packed", "rows", "shuffled"])
@pytest.mark.parametrize("n", [3000, 60000])
def test_pack_walks_matches_plain_on_any_walks(cuda, layout, n):
    """K14's pack entry on walks of 0 to 9000 ids (more than a block's
    4096-id window), a frame with no walk (frame 1 of 3), rows of 3000
    vertices (in shared memory) and of 60000 (past its 227 KB: read from
    device memory); walks back to back, each in a row of its own with room
    to spare, or back to back in a shuffled seed order (several runs of
    one frame in a block). Ids outside the walks stay untouched."""
    rng = np.random.default_rng(n)
    hops = rng.integers(0, n, (3, n), dtype=np.int32)
    hops[0, :n // 2] = np.arange(1, n // 2 + 1)             # a long path
    hops = torch.from_numpy(hops).to(cuda)
    seeds = np.concatenate([rng.choice(n, 700, replace=False),
                            2 * n + rng.choice(n, 700, replace=False)])
    seeds[:3] = [0, 1, 2]                                    # on the path
    seeds = np.sort(seeds)
    lens = rng.integers(0, 300, seeds.size).astype(np.int32)
    lens[:6] = [9000, 4097, 4096, 0, 1, 5000]
    if layout == "shuffled":
        order = rng.permutation(seeds.size)
        seeds, lens = seeds[order], lens[order]
    seeds = torch.from_numpy(seeds).to(cuda)
    lens = torch.from_numpy(lens).to(cuda)
    if layout == "rows":
        offsets = torch.arange(seeds.numel(), device=cuda) * 9100 + 3
        size = seeds.numel() * 9100 + 10
    else:
        offsets, size = _packed(lens)
        size += 3
    outs = _pack_pair(hops, seeds, lens, offsets, size)
    assert torch.equal(outs[0], outs[1])
    assert int((outs[0] != -7).sum()) == int(lens.sum())


def test_pack_walks_of_no_seeds_writes_nothing(cuda):
    hops = torch.zeros((2, 50), dtype=torch.int32, device=cuda)
    none = torch.zeros(0, dtype=torch.int64, device=cuda)
    out = torch.full((8,), -7, dtype=torch.int32, device=cuda)
    kst.pack_walks(hops, none, none.to(torch.int32), none, out)
    torch.cuda.synchronize()
    assert bool((out == -7).all())


@pytest.mark.parametrize("dtype", DTYPES)
def test_winding_kernel_matches_plain(cuda, dtype):
    mesh, v_world, _, _ = _velocity_field(cuda, dtype)
    centers = torch.tensor([17, 100, 119, 130, 200, 255], device=cuda)
    tabs = wind.ring_tables(mesh, centers, 8, dtype)
    args = (v_world, tabs.order, tabs.bounds, tabs.e1, tabs.e2)
    got = _launched("winding_profile", dtype, lambda: kwi.winding_profile(*args))
    _assert_same(got, kwi.plain_winding_profile(*args), dtype)
    assert got[0].shape == (6, v_world.shape[0]) and got[2].shape[-1] == 8


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("levels", [1, 40])
def test_winding_kernel_on_long_and_empty_rings(cuda, dtype, levels):
    """K15 on rings of 0 to 300 members (longer than a block's threads), a
    row staged in chunks at 40 rings, and an all-zero frame: counts and
    types equal the plain version's, w within TOL, non-finite values in the
    same places."""
    args = synthetic_rings(cuda, dtype, levels, seed=60 + levels)
    got = _launched("winding_profile", dtype, lambda: kwi.winding_profile(*args))
    want = kwi.plain_winding_profile(*args)
    _assert_same(got, want, dtype)
    assert got[2].shape == (3, 3, levels)
    if levels > 1:
        assert got[1][:2, 0].tolist() == [1, -1] and got[0][:2, 0].tolist() == [2, 4]


@pytest.mark.parametrize("dtype", DTYPES)
def test_winding_kernel_on_a_boundary_center(cuda, dtype):
    """K15 at 40 rings around a corner of the patch (its outer rings empty)
    and interior centers, with an all-zero frame appended."""
    mesh, v_world, _, _ = _velocity_field(cuda, dtype)
    v_world = torch.cat([v_world, torch.zeros_like(v_world[:1])]).contiguous()
    centers = torch.tensor([0, 100, 135], device=cuda)
    tabs = wind.ring_tables(mesh, centers, 40, dtype)
    assert int((tabs.bounds[0, 1:] == tabs.bounds[0, :-1]).sum()) > 0
    args = (v_world, tabs.order, tabs.bounds, tabs.e1, tabs.e2)
    got = _launched("winding_profile", dtype, lambda: kwi.winding_profile(*args))
    _assert_same(got, kwi.plain_winding_profile(*args), dtype)
    assert torch.equal(kwi.winding_profile(*args)[2], got[2])


def test_analysis_stages_on_cuda_match_cpu(cuda):
    """flow --classify, streamline and winding stages on the card against
    the same stages on the CPU: labels, polylines, ring counts equal."""
    mesh, pot, times = _flow_problem(cuda)
    cfg = PipelineConfig()
    cfg.solver.tol = 1e-10
    cfg.analysis.min_streamline_length = 4
    v_k = compute_velocity_fields(mesh, pot, times, method="cg", tol=1e-10).v_k
    runs = []
    for m in (mesh, mesh.to("cpu")):
        v_world, speed, v_max = recombine.velocity_to_world_and_speed(
            v_k.to(m.device), m.basis)
        kernels.reset_launches()
        pts, labels, centers = stages.singularity_stage(
            m, v_world, cfg, classify=True, return_centers=True, speed=speed,
            v_max=v_max)
        lines = stages.streamline_stage(m, v_world, cfg)
        wind_lines = stages.winding_stage(m, v_world, pts, cfg, centers=centers)
        torch.cuda.synchronize()
        runs.append((labels, lines, wind_lines, dict(kernels.LAUNCHES)))
    (labels, lines, wl, launches), (labels_c, lines_c, wl_c, launches_c) = runs
    for k in ("compact_detected<double>", "classify_candidates<double>",
              "next_hop<double>", "trace_walks<int>", "pack_walks<int>",
              "winding_profile<double>"):
        assert launches[k] == 1, k
    assert set(launches_c.values()) == {0}
    assert labels == labels_c and sum(len(x) for x in labels) > 0
    assert list(lines) == list(lines_c) and sum(len(x) for x in lines.values()) > 0
    for k in lines:
        assert len(lines[k]) == len(lines_c[k])
        for a, b in zip(lines[k], lines_c[k]):
            np.testing.assert_array_equal(a, b)
    assert {k: [r[1:] for r in v] for k, v in wl.items()} == {
        k: [r[1:] for r in v] for k, v in wl_c.items()}
    assert sum(len(v) for v in wl.values()) > 0


def _speed_close(got, want, mag, dtype):
    """Wave speeds: inf/NaN at the same places; elsewhere, where |grad| is
    above 1e-8 of its largest value, the relative error scaled by
    |grad| / max|grad| (the quotient amplifies rounding by its inverse)
    within TOL."""
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    top = float(mag.abs().max())
    ok = torch.isfinite(want) & (mag > 1e-8 * top) & (want != 0)
    err = ((got - want).abs() / want.abs() * mag / top)[ok]
    assert ok.any() and float(err.max()) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_wave_kernel_matches_plain(cuda, dtype):
    """K16 in each of its outputs, on a movie with a flat stretch (frames 2-4
    constant) where the speeds are inf and NaN."""
    mesh, pot, _ = _problem(cuda)
    movie = pot.to(dtype).clone()
    movie[2:5] = 0.0
    args = (mesh.triangles, mesh.grad_w.to(dtype), mesh.areas.to(dtype),
            mesh.vertex_cells, mesh.basis.to(dtype))
    mag = kfi.plain_wave_speed(movie, *args, 1.0 / 512, "magnitude")
    for output in kfi.WAVE_OUTPUTS:
        got = _launched("wave_speed", dtype,
                        lambda: kfi.wave_speed(movie, *args, 1.0 / 512, output))
        want = kfi.plain_wave_speed(movie, *args, 1.0 / 512, output)
        if output in ("gradient", "magnitude"):
            _assert_close([got], [want], dtype)
        else:
            _speed_close(got, want, mag, dtype)
            assert not torch.isfinite(got[3]).any()
    with pytest.raises(ValueError, match="at least 3 frames"):
        kfi.wave_speed(movie[:2].contiguous(), *args, 1.0, "amplitude")


# K17 rbf_fit's gate: the relative backward error max|A W - B| / max(|A| |W|)
# (an LU solve with partial pivoting is backward stable; its weights differ
# from the library's by up to cond(A) times the rounding).
FIT_TOL = {torch.float32: 1e-5, torch.float64: 1e-13}


def _fit_backward_error(a, w, planes):
    res = max(float((a @ wi - p.T).abs().max()) for wi, p in zip(w, planes))
    return res / max(max(float((a.abs() @ wi.abs()).max()) for wi in w), 1e-300)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", sorted(kfi.RBF_KINDS))
def test_rbf_kernels_match_plain(cuda, dtype, kind):
    """K17's fit (a smoothing diagonal; E = 1, 24, 64, 129, 200, 230 random
    electrodes, each with one plane of 1 or 37 frames and two planes of 98,
    R = 1, 37, 196) against its plain version: its backward error within
    FIT_TOL, the interpolant of its weights at the mesh's vertices against
    the plain weights' within TOL of max sum_e |phi| |w|, the same info
    word, two calls bitwise equal (E = 200 in float64 and E = 230 in both
    dtypes run in the workspace, past shared memory). Then K17's evaluation, real and phase,
    against its plain version; its error is relative to max sum_e |phi| |w|,
    its rounding scale."""
    mesh, pot, _ = _problem(cuda)
    x = mesh.points.to(dtype).contiguous()
    for n_elec in (1, 24, 64, 129, 200, 230):
        gen = np.random.default_rng(n_elec)
        c = torch.as_tensor(gen.uniform(0.0, 6.0, (n_elec, 3)), device=cuda).to(dtype)
        eps = interp.scipy_default_epsilon(c).reshape(1)
        a = kfi.plain_rbf_basis(c, eps, kind, smooth=0.1)
        b = kfi.rbf_phi(kfi.pairwise_dist(x, c), eps, kind)
        for n_planes, n_frames in ((1, 1), (1, 37), (2, 98)):
            planes = tuple(torch.as_tensor(gen.standard_normal((n_frames, n_elec)),
                                           device=cuda).to(dtype) for _ in range(n_planes))
            w, info = _launched("rbf_fit", dtype,
                                lambda: kfi.rbf_fit(c, eps, planes, kind, smooth=0.1))
            again, _ = kfi.rbf_fit(c, eps, planes, kind, smooth=0.1)
            want, info_p = kfi.plain_rbf_fit(c, eps, planes, kind, smooth=0.1)
            assert w.shape == (n_planes, n_elec, n_frames) and torch.equal(w, again)
            assert int(info[0]) == int(info_p[0]) == 0 and torch.isfinite(w).all()
            assert _fit_backward_error(a, w, planes) <= FIT_TOL[dtype]
            scale = max(float((b.abs() @ wi.abs()).max()) for wi in want)
            for wi, wj in zip(w, want):
                assert float((b @ wi - b @ wj).abs().max()) <= TOL[dtype] * scale
    gen = np.random.default_rng(3)
    sel = torch.as_tensor(gen.choice(mesh.n_vertices, 24, replace=False), device=cuda)
    c = x[sel].contiguous()
    eps = interp.scipy_default_epsilon(c).reshape(1)
    w, w_im = (torch.as_tensor(gen.standard_normal((24, 37)), device=cuda).to(dtype)
               for _ in range(2))
    b = kfi.rbf_phi(kfi.pairwise_dist(x, c), eps, kind)
    scale = float((b.abs() @ w.abs()).max())
    got = _launched("rbf_eval", dtype, lambda: kfi.rbf_eval(x, c, eps, w, kind))
    assert got.shape == (37, mesh.n_vertices)
    assert float((got - kfi.plain_rbf_eval(x, c, eps, w, kind)).abs().max()) <= TOL[dtype] * scale
    got = _launched("rbf_eval", dtype, lambda: kfi.rbf_eval(x, c, eps, w, kind, w_im))
    z = torch.complex((b @ w).T, (b @ w_im).T)
    assert float((z.abs() * torch.exp(1j * got) - z).abs().max()) <= 2 * TOL[dtype] * scale


@pytest.mark.parametrize("dtype", DTYPES)
def test_rbf_fit_coincident_pair_raises(cuda, dtype):
    """Two electrodes at one place (smooth = 0): K17's fit reports the zero
    pivot the plain version reports, and the interpolation raises ValueError
    on the card as on the CPU."""
    gen = np.random.default_rng(2)
    c = torch.as_tensor(gen.uniform(0.0, 6.0, (24, 3)), device=cuda).to(dtype)
    c[17] = c[5]
    eps = interp.scipy_default_epsilon(c).reshape(1)
    values = torch.as_tensor(gen.standard_normal((9, 24)), device=cuda).to(dtype)
    _, info = _launched("rbf_fit", dtype, lambda: kfi.rbf_fit(c, eps, (values,), "linear"))
    _, info_p = kfi.plain_rbf_fit(c, eps, (values,), "linear")
    assert int(info[0]) == int(info_p[0]) > 0
    with pytest.raises(ValueError, match=f"pivot {int(info[0])} is zero .*coincide"):
        interp.rbf_interpolate(c, values, c, kind="linear")


@pytest.mark.parametrize("n_frames", [1, 17, 98])
@pytest.mark.parametrize("dtype", DTYPES)
def test_wave_kernel_at_frame_group_edges(cuda, dtype, n_frames):
    """K16 against its plain version where its frame groups have edges: one
    frame, a last group cut short, the default path's 98 frames; every
    output the frame count allows, with frame 1 flat where there is one (inf
    and NaN masks equal)."""
    mesh, _, _ = _problem(cuda)
    gen = np.random.default_rng(n_frames)
    movie = torch.as_tensor(gen.standard_normal((n_frames, mesh.n_vertices)),
                            device=cuda).to(dtype)
    if n_frames > 1:
        movie[1] = 0.0
    args = (mesh.triangles, mesh.grad_w.to(dtype), mesh.areas.to(dtype),
            mesh.vertex_cells, mesh.basis.to(dtype))
    mag = kfi.plain_wave_speed(movie, *args, 1.0 / 512, "magnitude")
    for output in kfi.WAVE_OUTPUTS:
        if n_frames < kfi._MIN_FRAMES.get(output, 0):
            continue
        got = _launched("wave_speed", dtype,
                        lambda: kfi.wave_speed(movie, *args, 1.0 / 512, output))
        want = kfi.plain_wave_speed(movie, *args, 1.0 / 512, output)
        if output in ("gradient", "magnitude"):
            _assert_close([got], [want], dtype)
        else:
            _speed_close(got, want, mag, dtype)
            assert not torch.isfinite(got[1]).any()


@pytest.mark.parametrize("n_frames", [1, 17, 98])
@pytest.mark.parametrize("n_elec", [5, 70])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rbf_eval_at_tile_edges(cuda, dtype, n_elec, n_frames):
    """K17's evaluation, real and phase, where its tiles have edges: 141
    targets (no whole number of 8-target warps), 5 and 70 electrodes (part
    of one 64-electrode chunk, one and a part), 1, 17 and 98 frames; the
    error relative to max sum_e |phi| |w|, as above."""
    mesh, _, _ = _problem(cuda)
    gen = np.random.default_rng(n_elec + n_frames)
    x = mesh.points[:141].to(dtype).contiguous()
    c = torch.as_tensor(gen.uniform(0.0, 6.0, (n_elec, 3)), device=cuda).to(dtype)
    eps = interp.scipy_default_epsilon(c).reshape(1)
    w, w_im = (torch.as_tensor(gen.standard_normal((n_elec, n_frames)), device=cuda).to(dtype)
               for _ in range(2))
    b = kfi.rbf_phi(kfi.pairwise_dist(x, c), eps, "multiquadric")
    scale = float((b.abs() @ w.abs()).max())
    got = _launched("rbf_eval", dtype, lambda: kfi.rbf_eval(x, c, eps, w, "multiquadric"))
    assert got.shape == (n_frames, 141)
    want = kfi.plain_rbf_eval(x, c, eps, w, "multiquadric")
    assert float((got - want).abs().max()) <= TOL[dtype] * scale
    got = _launched("rbf_eval", dtype,
                    lambda: kfi.rbf_eval(x, c, eps, w, "multiquadric", w_im))
    z = torch.complex((b @ w).T, (b @ w_im).T)
    assert float((z.abs() * torch.exp(1j * got) - z).abs().max()) <= 2 * TOL[dtype] * scale


def test_field_stages_on_cuda_match_cpu(cuda):
    """S2, S4 and S5 on the card against the same stages on the CPU, with
    K16 and K17 launched on the card and nothing on the CPU."""
    mesh, pot, _ = _problem(cuda)
    cfg = PipelineConfig()
    sel = np.random.default_rng(4).choice(mesh.n_vertices, 30, replace=False)
    coords = mesh.points.cpu().numpy()[sel]
    data = np.cos(np.linspace(0.0, 9.0, 40))[:, None] * pot.cpu().numpy()[:1, sel] + 0.1
    cpu = mesh.to("cpu")
    movies = [stages.interpolate_stage(cpu, coords, data, cfg, phases=p) for p in (False, True)]
    mags = [wave.tangential_gradient_magnitude(cpu, x) for x in movies]
    runs = []
    for m in (mesh, cpu):
        kernels.reset_launches()
        amp = stages.interpolate_stage(m, coords, data, cfg)
        phases = stages.interpolate_stage(m, coords, data, cfg, phases=True)
        speeds = [stages.wavespeed_stage(m, x, 1.0 / 512, method=method)
                  for x, method in zip(movies, ("amplitude", "phase"))]
        v_k = torch.as_tensor(np.random.default_rng(5).standard_normal(
            (12, m.n_dof)), device=m.device)
        modes = [stages.decompose_stage(v_k, cfg, mode=mode) for mode in ("concat", "complex")]
        if m.device.type == "cuda":
            torch.cuda.synchronize()
        runs.append((amp, phases, speeds, modes, dict(kernels.LAUNCHES)))
    (amp, phases, speeds, modes, launches), (amp_c, phases_c, speeds_c, modes_c, lc) = runs
    assert launches["rbf_fit<double>"] == 2 and launches["rbf_eval<double>"] == 2
    assert launches["wave_speed<double>"] == 2 and set(lc.values()) == {0}
    scale = float(amp_c.abs().max())
    assert float((amp.cpu() - amp_c).abs().max()) <= 1e-9 * scale
    assert float(torch.angle(torch.exp(1j * (phases.cpu() - phases_c))).abs().max()) <= 1e-9
    for a, b, mag in zip(speeds, speeds_c, mags):
        _speed_close(a.cpu(), b, mag, torch.float64)
    for a, b in zip(modes, modes_c):
        torch.testing.assert_close(a.sigma.cpu(), b.sigma, rtol=1e-10, atol=0)
        recon = [(m.u * m.sigma.to(m.u.dtype)) @ m.vt for m in (a, b)]
        torch.testing.assert_close(recon[0].cpu(), recon[1], rtol=0, atol=1e-8 * float(
            recon[1].abs().max()))
