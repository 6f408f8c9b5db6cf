// Kernels of the field stages: K16, the wave speeds of S5 (with the spatial
// gradients they divide by), and K17, the RBF interpolation of S2 (its fit,
// the weights of every frame, and its evaluation at the surface's vertices).
// Layouts follow the JAX package (TriMesh tables, ops/interpolate.py):
//   movie         (T, N)      amplitude or phase movie
//   triangles     (M, 3)      int32 corner vertex ids
//   grad_w        (M, 3, 3)   P1 hat gradients per corner
//   areas         (M,)        triangle areas
//   vertex_cells  (N, C)      int32 incident cells, ascending, -1 padded
//   basis         (N, 2, 3)   tangent bases (e1, e2)
//   c             (E, 3)      the electrodes; x (P, 3) the evaluation points
//   eps           (1,)        the RBF shape parameter, on the device
//   b0, b1        (T, E)      the values to fit, one plane or two (cos, sin)
//   w, w_im       (E, T)      RBF weights per frame (real, imaginary part);
//                             the fit writes the planes' (planes, E, T)
// The C entry points return the cudaError_t of the launch.
#include <type_traits>

#include "common.cuh"

namespace mf {

// What K16 writes (kernels/fields.py WAVE_OUTPUTS): the gradient vectors
// (T, N, 3), |tangential gradient| (T, N), or the wave speed (T, N) of the
// amplitude method, the phase method, or the phase method's |speed| / 1000.
enum WaveOutput : int {
  kGradient = 0, kMagnitude = 1, kAmplitude = 2, kPhase = 3, kPhaseMmPerMs = 4
};

// ops/phase.py:58 angle_subtract: mod(a - b + pi, 2 pi) - pi with jnp.mod's
// sign rule (fmod, then add the divisor where the remainder is non-zero and
// its sign differs from the divisor's), so +-pi wrap as in JAX.
template <typename T>
__device__ __forceinline__ T angle_subtract(T a, T b) {
  const T pi = T(3.141592653589793), two_pi = T(6.283185307179586);
  T r = fmod(rn_add(rn_sub(a, b), pi), two_pi);
  if (r != T(0) && r < T(0)) r = rn_add(r, two_pi);
  return rn_sub(r, pi);
}

// The time derivative at frame t of the movie column mv (mv[t * n_vert] is
// frame t's value at the vertex): ops/phase.py:66's np.gradient(edge_order=2)
// for the amplitude method, :78's wrapped differences for the phase methods.
template <typename T>
__device__ __forceinline__ T time_derivative(const T* __restrict__ mv, int64_t t,
                                             int64_t n_frames, int64_t n_vert,
                                             double dt, int output) {
  const int64_t last = n_frames - 1;
  if (output == kAmplitude) {
    // np.gradient(edge_order=2): one-sided second-order stencils at the ends.
    T d;
    if (t == 0) {
      d = rn_div(rn_sub(rn_add(rn_mul(T(-3), mv[0]), rn_mul(T(4), mv[n_vert])),
                        mv[2 * n_vert]), T(2));
    } else if (t == last) {
      d = rn_div(rn_add(rn_sub(rn_mul(T(3), mv[last * n_vert]),
                               rn_mul(T(4), mv[(last - 1) * n_vert])),
                        mv[(last - 2) * n_vert]), T(2));
    } else {
      d = rn_div(rn_sub(mv[(t + 1) * n_vert], mv[(t - 1) * n_vert]), T(2));
    }
    return rn_div(d, T(dt));
  }
  if (t == 0) return rn_div(angle_subtract(mv[n_vert], mv[0]), T(dt));
  if (t == last) {
    return rn_div(angle_subtract(mv[last * n_vert], mv[(last - 1) * n_vert]), T(dt));
  }
  return rn_div(angle_subtract(mv[(t + 1) * n_vert], mv[(t - 1) * n_vert]),
                T(2.0 * dt));
}

// K16's launch shape (the sweep of chip_smoke.py on the H100): F frames a
// thread (its sums: 3F + 1 values), threads a block, and blocks an SM the
// registers are capped for. Latency, not throughput, bounds the kernel, so more
// resident warps gain more than the spills to L1 that the cap causes cost.
constexpr int kWaveFrames = 4;
constexpr int kWaveThreads = 128;
constexpr int kWaveMinBlocks = 5;

// One incident cell's tables: its corner ids, grad_w row and area.
template <typename T>
struct CellTables {
  int32_t c[3];
  T gw[9];
  T a;
};

template <typename T>
__device__ __forceinline__ void load_cell(int64_t m, CellTables<T>& ct,
                                          const int32_t* __restrict__ triangles,
                                          const T* __restrict__ grad_w,
                                          const T* __restrict__ areas) {
#pragma unroll
  for (int j = 0; j < 3; ++j) ct.c[j] = triangles[3 * m + j];
#pragma unroll
  for (int j = 0; j < 9; ++j) ct.gw[j] = grad_w[9 * m + j];
  ct.a = areas[m];
}

// Replaces ops/wavespeed.py:28 vertex_gradients, :52
// tangential_gradient_magnitude, :64 wave_velocity_amplitude, :72
// wave_velocity_phase (and :79's abs / 1000) with ops/phase.py:66 and :78's
// temporal derivatives (B13), in one pass.
// Bound on this card: bytes by the count of the bound (the movie once, one
// value or vector per (frame, vertex), the mesh tables once); in fact the
// latency of its dependent loads (a slot's cell id, then the cell's
// tables, then the corner values), six cells in turn, with its f64
// arithmetic: each vertex forms the gradient of each incident cell again
// (three times a cell) and the quotients are separately rounded divisions.
// Design: a block takes a tile of consecutive vertices, a thread one
// vertex, and a group of F consecutive frames (blockIdx.y, by gridDim.y
// past 65535 groups), so the movie's reads and the output's writes coalesce
// across a warp. Each vertex walks its vertex_cells row in slot order once
// a group: each cell's corner ids, grad_w row and area are read once and
// applied to each of the F frames, whose three corner values are the only
// per-frame loads. Each frame's sum, the division (den > 0, else 1), the
// tangent projection and the time derivative are the first design's
// operations in its order, so every output is the same bits; the basis'
// normal, |n|^2 and the |e|^2 are formed once a group. No intermediate
// (T, M, 3) or (T, N, 3) reaches memory.
template <typename T>
__global__ void __launch_bounds__(kWaveThreads, kWaveMinBlocks) wave_speed_kernel(
    const T* __restrict__ movie, const int32_t* __restrict__ triangles,
    const T* __restrict__ grad_w, const T* __restrict__ areas,
    const int32_t* __restrict__ vertex_cells, const T* __restrict__ basis,
    T* __restrict__ out, int64_t n_frames, int64_t n_vert, int64_t width,
    double dt, int output) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= n_vert) return;
  const int32_t* row = vertex_cells + v * width;
  const T* mv = movie + v;
  constexpr int F = kWaveFrames;
  const int64_t n_groups = (n_frames + F - 1) / F;
  for (int64_t group = blockIdx.y; group < n_groups; group += gridDim.y) {
    const int64_t t0 = group * F;
    const int64_t nf = n_frames - t0 < F ? n_frames - t0 : F;
    const T* frames = movie + t0 * n_vert;
    T num[F][3];
#pragma unroll
    for (int f = 0; f < F; ++f) num[f][0] = num[f][1] = num[f][2] = T(0);
    T den = T(0);
    for (int64_t s = 0; s < width; ++s) {
      const int32_t m = row[s];
      if (m < 0) continue;
      CellTables<T> ct;
      load_cell(m, ct, triangles, grad_w, areas);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        if (f < nf) {
          const T* frame = frames + f * n_vert;
          const T i0 = frame[ct.c[0]], i1 = frame[ct.c[1]], i2 = frame[ct.c[2]];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const T g = rn_add(rn_add(rn_mul(i0, ct.gw[d]), rn_mul(i1, ct.gw[3 + d])),
                               rn_mul(i2, ct.gw[6 + d]));
            num[f][d] = rn_add(num[f][d], rn_mul(g, ct.a));
          }
        }
      }
      den = rn_add(den, ct.a);
    }
    const T scale = den > T(0) ? den : T(1);
    // geometry/tangent.py: project_to_plane, then express_on_basis; the
    // frame-free quantities once a group, after the sums (fewer registers
    // live across the cell loop).
    const T* e = basis + 6 * v;
    const T e1[3] = {e[0], e[1], e[2]}, e2[3] = {e[3], e[4], e[5]};
    T n[3];
    cross3(e1, e2, n);
    const T nn = dot3(n, n);
    const T n_scale = nn > T(0) ? nn : T(1);
    const T e11 = dot3(e1, e1), e22 = dot3(e2, e2);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      if (f < nf) {
        const int64_t t = t0 + f;
        T g[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) g[d] = rn_div(num[f][d], scale);
        if (output == kGradient) {
#pragma unroll
          for (int d = 0; d < 3; ++d) out[3 * (t * n_vert + v) + d] = g[d];
          continue;
        }
        const T vn = rn_div(dot3(g, n), n_scale);
        const T along = nn > T(0) ? vn : T(0);
        T p[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) p[d] = rn_sub(g[d], rn_mul(along, n[d]));
        const T ca = rn_div(dot3(p, e1), e11);
        const T cb = rn_div(dot3(p, e2), e22);
        const T mag = rn_sqrt(rn_add(rn_mul(ca, ca), rn_mul(cb, cb)));
        if (output == kMagnitude) {
          out[t * n_vert + v] = mag;
          continue;
        }
        T speed = rn_div(time_derivative(mv, t, n_frames, n_vert, dt, output), mag);
        if (output == kPhaseMmPerMs) speed = rn_div(fabs(speed), T(1000));
        out[t * n_vert + v] = speed;
      }
    }
  }
}

template <typename T>
int wave_speed(const void* movie, const void* triangles, const void* grad_w,
               const void* areas, const void* vertex_cells, const void* basis, void* out,
               int64_t n_frames, int64_t n_vert, int64_t width, double dt, int64_t output,
               void* stream) {
  if (n_frames <= 0 || n_vert <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t n_groups = (n_frames + kWaveFrames - 1) / kWaveFrames;
  const dim3 grid(static_cast<unsigned int>((n_vert + kWaveThreads - 1) / kWaveThreads),
                  static_cast<unsigned int>(n_groups < 65535 ? n_groups : 65535));
  wave_speed_kernel<T><<<grid, kWaveThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(movie), static_cast<const int32_t*>(triangles),
      static_cast<const T*>(grad_w), static_cast<const T*>(areas),
      static_cast<const int32_t*>(vertex_cells), static_cast<const T*>(basis),
      static_cast<T*>(out), n_frames, n_vert, width, dt, static_cast<int>(output));
  return static_cast<int>(cudaGetLastError());
}

// The SM count of the current device, read once.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

// ops/interpolate.py:34 _kernel of a distance r (kernels/fields.py
// RBF_KINDS): multiquadric, inverse multiquadric, gaussian, linear, thin
// plate. The linear and thin-plate kernels ignore eps, as in JAX.
template <typename T>
__device__ __forceinline__ T rbf_phi(T r, T eps, int kind) {
  if (kind == 3) return r;
  if (kind == 4) return r > T(0) ? rn_mul(rn_mul(r, r), log(r)) : T(0);
  const T q = rn_div(r, eps);
  const T q2 = rn_mul(q, q);
  if (kind == 2) return exp(-q2);
  const T s = rn_sqrt(rn_add(q2, T(1)));
  return kind == 1 ? rn_div(T(1), s) : s;
}

// ops/interpolate.py:48 _pairwise_dist for one pair: sqrt(max(sum of the
// squared differences over x, y, z in that order, 0)).
template <typename T>
__device__ __forceinline__ T pair_distance(const T* a, const T* b) {
  const T dx = rn_sub(a[0], b[0]), dy = rn_sub(a[1], b[1]), dz = rn_sub(a[2], b[2]);
  const T d2 = rn_add(rn_add(rn_mul(dx, dx), rn_mul(dy, dy)), rn_mul(dz, dz));
  return rn_sqrt(d2 > T(0) ? d2 : T(0));
}

// K17's fit (rbf_fit_kernel): 256 threads a block, each block at most
// kFitCols right-hand sides (kFitColsWarp a warp in the back substitution);
// the factorization in panels of kFitPanel columns.
constexpr int kFitThreads = 256;
constexpr int kFitWarps = kFitThreads / 32;
constexpr int kFitLanes = 4;                        // lanes a row in the update
constexpr int kFitGroups = kFitThreads / kFitLanes;
constexpr int kFitCols = 32;
constexpr int kFitColsWarp = kFitCols / kFitWarps;
constexpr int kFitPanel = 8;

// The row stride (elements) of the augmented matrix [A | B] of `width`
// columns: the least >= width that is 4 mod 16 (float64) or 4 mod 32
// (float32), so the 8 rows x 4 consecutive columns a warp updates fall in
// distinct banks.
template <typename T>
__host__ __device__ constexpr int64_t fit_ld(int64_t width) {
  constexpr int64_t m = sizeof(T) == 8 ? 16 : 32;
  return 4 + (width - 4 + m - 1) / m * m;
}

// A block's working set: the augmented matrix, the electrodes, then each
// row's position in the pivoted order and the row of each position.
template <typename T>
__host__ __device__ constexpr int64_t fit_matrix_bytes(int64_t n_elec, int64_t ld) {
  return (n_elec * (ld + 3) * static_cast<int64_t>(sizeof(T)) + 15) / 16 * 16;
}
template <typename T>
__host__ __device__ constexpr int64_t fit_bytes(int64_t n_elec, int64_t ld) {
  return fit_matrix_bytes<T>(n_elec, ld) + (8 * n_elec + 15) / 16 * 16;
}

// LAPACK's sfmin (dlamch('S')): below it dgetf2 divides by the pivot
// instead of scaling by its reciprocal.
template <typename T>
__device__ __forceinline__ T fit_sfmin() {
  return sizeof(T) == 8 ? T(2.2250738585072014e-308) : T(1.17549435e-38f);
}

// |x| as an unsigned integer of the same order (IEEE bits of a non-negative
// value), the pivot search's key.
__device__ __forceinline__ unsigned long long fit_key(double x) {
  return static_cast<unsigned long long>(__double_as_longlong(fabs(x)));
}
__device__ __forceinline__ unsigned long long fit_key(float x) {
  return __float_as_uint(fabsf(x));
}

// A pivot candidate: its key, its position in the pivoted order, its row in
// storage and its value; none is (0, ~0, ~0, 0).
template <typename T>
struct FitCand {
  unsigned long long key;
  unsigned int pos, row;
  T value;
};

// LAPACK's idamax rule: the largest |a|, the first position among equals.
template <typename T>
__device__ __forceinline__ void fit_consider(FitCand<T>& best, T value, unsigned int pos,
                                             unsigned int row) {
  const unsigned long long key = fit_key(value);
  if (key > best.key || (key == best.key && pos < best.pos)) best = {key, pos, row, value};
}

// The same rule over the lanes of a warp: the lane that holds the winner
// (every lane gets it). Three reductions (the key's halves, then the
// position among the largest), then a vote.
template <typename T>
__device__ __forceinline__ int fit_warp_best(const FitCand<T>& c) {
  const unsigned int hi = static_cast<unsigned int>(c.key >> 32);
  const unsigned int lo = static_cast<unsigned int>(c.key);
  const unsigned int mhi = __reduce_max_sync(0xffffffffu, hi);
  const unsigned int mlo = __reduce_max_sync(0xffffffffu, hi == mhi ? lo : 0u);
  const bool top = hi == mhi && lo == mlo;
  const unsigned int mpos = __reduce_min_sync(0xffffffffu, top ? c.pos : ~0u);
  return __ffs(__ballot_sync(0xffffffffu, top && c.pos == mpos)) - 1;
}

// Replaces ops/interpolate.py:90-133 _rbf_solve's fit (B14): the system
// A = phi(|c_i - c_j|) - smooth I (bitwise the first design's matrix: the
// same rbf_phi and pair_distance), P A = L U with partial pivoting as
// LAPACK's dgetf2 (the first position of the largest |a_ik|, the column
// below scaled by the pivot's reciprocal), and W = A^-1 B for the
// right-hand sides B: the columns t of each plane (T, E), read as they lie;
// W written (planes, E, T), the layout rbf_eval reads. info is the first
// zero pivot, 1-based, or 0 (written by block 0, with the pivots, 1-based,
// where piv is given).
// Bound on this card: 2/3 E^3 + 2 E^2 R f64 operations or the bytes of c,
// B and W, whichever is larger (a few ns at E = 64); in fact the dependent
// chain of E pivot steps and E back-substitution steps (the forward
// substitution rides in the factorization), each some hundred cycles of
// warp reductions, shuffles and shared-memory round trips.
// Design: one block for each group of at most kFitCols right-hand sides;
// every block builds [A | B] (its own columns of B) in shared memory (in
// its slice of `work` where that does not fit) and factors it alone, so no
// grid-wide sync or second launch is needed. The factorization runs in
// panels of kFitPanel columns. Warp 0 factors a panel alone, with no block
// barrier inside: each step reduces the lanes' candidates with the idamax
// rule (each lane has formed its candidate's reciprocal meanwhile), takes
// the winner's row, reciprocal and value by shuffles, and each lane scales
// its rows' entries and updates the panel's columns to the right in
// registers, forming its candidate for the next column as it goes; rows
// stay in place and their pivoted positions are tracked. Then the block
// solves the panel's rows of U right of it (each column's chain in order)
// and applies the panel's rank-1 updates to the rows below, each element's
// updates in pivot order as dgetf2 makes them, B's columns too (the
// forward substitution with unit L): three barriers a panel. The back
// substitution with U is a warp's for its columns, 32 rows at a time in
// registers, the quotient passed by a shuffle (y / d as y r, corrected by
// one fused multiply-add, r = 1/d formed once a row), then the rows above.
// Every sum has a fixed order, so calls repeat bit for bit. Offsets are
// 32-bit in shared memory, 64-bit in the workspace.
template <typename T, bool kShared>
__global__ void __launch_bounds__(kFitThreads) rbf_fit_kernel(
    const T* __restrict__ c, const T* __restrict__ eps, const T* __restrict__ b0,
    const T* __restrict__ b1, T* __restrict__ w, int32_t* __restrict__ info_out,
    int32_t* __restrict__ piv_out, unsigned char* __restrict__ work, int64_t n_elec,
    int64_t n_frames, int64_t n_rhs, int64_t ld_, int64_t stride, int kind, double smooth) {
  using I = typename std::conditional<kShared, int, int64_t>::type;
  extern __shared__ __align__(16) unsigned char fit_smem[];
  unsigned char* base;
  if constexpr (kShared) {
    base = fit_smem;
  } else {
    base = work + static_cast<int64_t>(blockIdx.x) * stride;
  }
  const I E = static_cast<I>(n_elec), ld = static_cast<I>(ld_);
  T* a = reinterpret_cast<T*>(base);
  T* cs = a + E * ld;
  int32_t* pos = reinterpret_cast<int32_t*>(base + fit_matrix_bytes<T>(n_elec, ld_));
  int32_t* prow = pos + E;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kFitCols;
  const I nc = static_cast<I>(n_rhs - q0 < kFitCols ? n_rhs - q0 : kFitCols);
  const I width = E + nc;
  const T e_shape = eps[0];

  // [A | B] (A's upper triangle computed, mirrored: pair_distance is
  // symmetric bit for bit) and the identity order.
  for (I k = tid; k < 3 * E; k += kFitThreads) cs[k] = c[k];
  for (I k = tid; k < E; k += kFitThreads) pos[k] = static_cast<int32_t>(k);
  for (I col = warp; col < nc; col += kFitWarps) {
    const int64_t q = q0 + col;
    const bool second = q >= n_frames;
    const T* plane = (second ? b1 : b0) + (q - (second ? n_frames : 0)) * n_elec;
    for (I r = lane; r < E; r += 32) a[r * ld + E + col] = plane[r];
  }
  __syncthreads();
  for (I i = warp; i < E; i += kFitWarps) {
    for (I j = i + lane; j < E; j += 32) {
      const T phi = rbf_phi(pair_distance(cs + 3 * i, cs + 3 * j), e_shape, kind);
      a[i * ld + j] = i == j ? rn_sub(phi, T(smooth)) : phi;
      if (j != i) a[j * ld + i] = phi;
    }
  }
  __syncthreads();

  int32_t info = 0;
  const int g = tid / kFitLanes, l = tid % kFitLanes;
  const FitCand<T> none = {0ull, ~0u, ~0u, T(0)};
  for (I p0 = 0; p0 < E; p0 += kFitPanel) {
    const I p1 = p0 + kFitPanel < E ? p0 + kFitPanel : E;
    const int nb = static_cast<int>(p1 - p0);
    if (warp == 0) {
      // The panel's first column's candidates, then dgetf2's steps.
      FitCand<T> best = none;
      for (I r = lane; r < E; r += 32) {
        const int32_t p = pos[r];
        if (p >= p0) {
          fit_consider(best, a[r * ld + p0], static_cast<unsigned int>(p),
                       static_cast<unsigned int>(r));
        }
      }
#pragma unroll
      for (int kk = 0; kk < kFitPanel; ++kk) {
        if (kk < nb) {
          const I k = p0 + kk;
          const T mine = best.value;
          const T my_rinv = fabs(mine) >= fit_sfmin<T>() ? rn_div(T(1), mine) : T(1);
          const int src = fit_warp_best(best);
          const I lp = static_cast<I>(__shfl_sync(0xffffffffu, best.pos, src));
          const I pr = static_cast<I>(__shfl_sync(0xffffffffu, best.row, src));
          const T piv = __shfl_sync(0xffffffffu, mine, src);
          const T rinv = __shfl_sync(0xffffffffu, my_rinv, src);
          const bool zero = piv == T(0);
          const bool recip = fabs(piv) >= fit_sfmin<T>();
          if (zero && info == 0) info = static_cast<int32_t>(k + 1);
          if (lane == 0) {
            prow[k] = static_cast<int32_t>(pr);
            if (piv_out != nullptr && blockIdx.x == 0) piv_out[k] = static_cast<int32_t>(lp + 1);
          }
          const T* pivot_row = a + pr * ld + p0;
          T u[kFitPanel];
#pragma unroll
          for (int jj = kk + 1; jj < kFitPanel; ++jj) u[jj] = jj < nb ? pivot_row[jj] : T(0);
          best = none;
          for (I r = lane; r < E; r += 32) {
            const int32_t p = pos[r];
            const int32_t np = r == pr ? static_cast<int32_t>(k)
                                       : (p == k ? static_cast<int32_t>(lp) : p);
            if (np != p) pos[r] = np;
            if (np <= k) continue;  // the pivot row, or a row of U already
            T* row = a + r * ld + p0;
            T v[kFitPanel];
#pragma unroll
            for (int jj = kk; jj < kFitPanel; ++jj) v[jj] = jj < nb ? row[jj] : T(0);
            const T lr = zero ? v[kk] : (recip ? rn_mul(v[kk], rinv) : rn_div(v[kk], piv));
            row[kk] = lr;
#pragma unroll
            for (int jj = kk + 1; jj < kFitPanel; ++jj) {
              if (jj < nb) {
                v[jj] = rn_fma(-lr, u[jj], v[jj]);
                row[jj] = v[jj];
              }
            }
            if (kk + 1 < nb) {
              fit_consider(best, v[kk + 1], static_cast<unsigned int>(np),
                           static_cast<unsigned int>(r));
            }
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
    // The panel's rows of U right of it (B's columns too): each column's
    // chain in pivot order, in registers.
    T* urow[kFitPanel];
#pragma unroll
    for (int m = 0; m < kFitPanel; ++m) urow[m] = a + (m < nb ? prow[p0 + m] : 0) * ld;
    for (I j = p1 + tid; j < width; j += kFitThreads) {
      T u[kFitPanel];
#pragma unroll
      for (int m = 0; m < kFitPanel; ++m) u[m] = m < nb ? urow[m][j] : T(0);
#pragma unroll
      for (int kk = 1; kk < kFitPanel; ++kk) {
        if (kk < nb) {
#pragma unroll
          for (int m = 0; m < kk; ++m) u[kk] = rn_fma(-urow[kk][p0 + m], u[m], u[kk]);
        }
      }
#pragma unroll
      for (int m = 1; m < kFitPanel; ++m) {
        if (m < nb) urow[m][j] = u[m];
      }
    }
    __syncthreads();
    // The rows below the panel: the panel's rank-1 updates in pivot order,
    // a row to kFitLanes lanes (columns j = l mod 4, four at a time), its
    // multipliers in registers.
    for (I r = g; r < E; r += kFitGroups) {
      if (pos[r] < p1) continue;
      T* row = a + r * ld;
      T lr[kFitPanel];
#pragma unroll
      for (int m = 0; m < kFitPanel; ++m) lr[m] = m < nb ? row[p0 + m] : T(0);
      I j = p1 + l;
      for (; j + 3 * kFitLanes < width; j += 4 * kFitLanes) {
        T acc[4], uu[4][kFitPanel];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[q] = row[j + q * kFitLanes];
#pragma unroll
          for (int m = 0; m < kFitPanel; ++m) uu[q][m] = m < nb ? urow[m][j + q * kFitLanes] : T(0);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int m = 0; m < kFitPanel; ++m) {
            if (m < nb) acc[q] = rn_fma(-lr[m], uu[q][m], acc[q]);
          }
          row[j + q * kFitLanes] = acc[q];
        }
      }
      for (; j < width; j += kFitLanes) {
        T acc = row[j];
#pragma unroll
        for (int m = 0; m < kFitPanel; ++m) {
          if (m < nb) acc = rn_fma(-lr[m], urow[m][j], acc);
        }
        row[j] = acc;
      }
    }
    __syncthreads();
  }
  if (blockIdx.x == 0 && tid == 0) info_out[0] = info;

  // U x = y for the warp's columns, 32 rows at a time from the bottom: lane
  // i's row in registers, x_k from lane k by a shuffle; then the rows above
  // take the block's x in descending k (dtrsm's order). A warp with no
  // column left has nothing to do.
  const I c0 = warp * kFitColsWarp;
  if (c0 >= nc) return;
  for (I hi = E; hi > 0; hi -= 32) {
    const I lo = hi > 32 ? hi - 32 : 0;
    const I i = lo + lane;
    const bool in = i < hi;
    const T* ri = a + (in ? prow[i] : 0) * ld;
    T y[kFitColsWarp], x[kFitColsWarp];
#pragma unroll
    for (int cc = 0; cc < kFitColsWarp; ++cc) {
      y[cc] = in && c0 + cc < nc ? ri[E + c0 + cc] : T(0);
      x[cc] = T(0);
    }
    const T d = in ? ri[i] : T(1);
    const T rd = rn_div(T(1), d);
    for (I k = hi - 1; k >= lo; --k) {
      const int src = static_cast<int>(k - lo);
      const bool below = in && i < k;
      const T u = below ? ri[k] : T(0);
#pragma unroll
      for (int cc = 0; cc < kFitColsWarp; ++cc) {
        const T q = rn_mul(y[cc], rd);
        const T xk = __shfl_sync(0xffffffffu, rn_fma(rn_fma(-q, d, y[cc]), rd, q), src);
        if (lane == src) x[cc] = xk;
        if (below) y[cc] = rn_fma(-xk, u, y[cc]);
      }
    }
#pragma unroll
    for (int cc = 0; cc < kFitColsWarp; ++cc) {
      const I col = c0 + cc;
      if (in && col < nc) {
        const int64_t q = q0 + col;
        const bool second = q >= n_frames;
        w[((second ? n_elec : 0) + i) * n_frames + q - (second ? n_frames : 0)] = x[cc];
      }
    }
    for (I r0 = 0; r0 < lo; r0 += 32) {
      const I r = r0 + lane;
      const bool mine = r < lo;
      T* rr = a + (mine ? prow[r] : 0) * ld;
      T acc[kFitColsWarp];
#pragma unroll
      for (int cc = 0; cc < kFitColsWarp; ++cc) {
        acc[cc] = mine && c0 + cc < nc ? rr[E + c0 + cc] : T(0);
      }
      for (I k = hi - 1; k >= lo; --k) {
        const T u = mine ? rr[k] : T(0);
#pragma unroll
        for (int cc = 0; cc < kFitColsWarp; ++cc) {
          acc[cc] = rn_fma(-__shfl_sync(0xffffffffu, x[cc], static_cast<int>(k - lo)), u,
                           acc[cc]);
        }
      }
#pragma unroll
      for (int cc = 0; cc < kFitColsWarp; ++cc) {
        if (mine && c0 + cc < nc) rr[E + c0 + cc] = acc[cc];
      }
    }
    __syncwarp();
  }
}

// K17's evaluation tiles. A warp owns 8 targets (the n side of the
// product) and every frame of its block (the m side, R a tile); the
// electrodes are the k side, kEvalElec a chunk, K a step. float64 takes
// m16n8k8 MMAs (R = 16, K = 8); float32 the m8n8k4 layout on the CUDA
// cores (R = 8, K = 4). Four warps a block (the launch-shape sweep of
// chip_smoke.py on the H100).
constexpr int kEvalElec = 64;
constexpr int kEvalPhi = kEvalElec / 4;  // phi values a lane keeps: electrodes 4s + q
constexpr int kEvalWarps = 4;            // 32 targets a block

template <typename T>
__host__ __device__ constexpr int eval_rows() {
  return sizeof(T) == 8 ? 16 : 8;
}
template <typename T>
__host__ __device__ constexpr int eval_depth() {
  return sizeof(T) == 8 ? 8 : 4;
}

// A W row of a block's frames in shared memory: R MT frames and 4 of
// padding, so that the fragment loads of a half-warp (4 electrodes x 4
// frames, f64) fall in 16 distinct bank pairs.
template <int R, int MT>
__host__ __device__ constexpr int eval_stride() {
  return R * MT + 4;
}

// Dynamic shared memory of a block: the W (and W_im) chunk, then the
// chunk's electrodes.
template <typename T, bool kPhase, int R, int MT>
constexpr size_t eval_smem_bytes() {
  return ((kPhase ? 2 : 1) * kEvalElec * eval_stride<R, MT>() + 3 * kEvalElec) * sizeof(T);
}

// One element copied from global to shared memory without a register:
// cp.async (sm_80+), waited for by cp_async_wait_all.
template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  const unsigned int dst = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
               :: "r"(dst), "l"(gmem), "n"(static_cast<int>(sizeof(T))));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// D (16 x 8) += A (16 x 8) B (8 x 8) on the f64 tensor cores (m16n8k8,
// sm_90). Fragments of lane l, g = l / 4, q = l % 4: a[i] = A[g + 8 (i % 2)]
// [q + 4 (i / 2)], b[i] = B[q + 4 i][g], c[i] = D[g + 8 (i / 2)][2 q + i % 2].
__device__ __forceinline__ void mma_m16n8k8(double* c, const double* a, const double* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// One k-step s of a warp's frame tiles: acc[j] (+ acc_im[j]) += the tile j
// of W^T (W_im^T) at the chunk's electrodes K s .. K s + K - 1 times the phi
// fragments b (b[K s / 4 + i] holds electrode K s + 4 i + q). float64 on
// the tensor cores; float32 (R = 8, K = 4) in exact FMAs on the CUDA cores
// (TF32 would keep 10 mantissa bits), each lane gathering the phi values of
// its two output targets from the lanes that hold them and summing the
// four electrodes in ascending order, in the same output layout.
template <typename T, bool kPhase, int R, int K, int MT>
__device__ __forceinline__ void eval_step(T (&acc)[MT][R / 4], T (&acc_im)[MT][R / 4],
                                          const T* ws, const T* ws_im, const T* b, int s,
                                          int mtiles, int lane) {
  constexpr int kStride = eval_stride<R, MT>();
  const int g = lane >> 2, q = lane & 3;
  if constexpr (sizeof(T) == 8) {
    static_assert(R == 16 && K == 8, "float64 takes the m16n8k8 product");
    constexpr int kA = R * K / 32, kHalves = R / 8;
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      if (j < mtiles) {
        T a[kA], ai[kA];
#pragma unroll
        for (int i = 0; i < kA; ++i) {
          const int at = (K * s + q + 4 * (i / kHalves)) * kStride + R * j + g +
                         8 * (i % kHalves);
          a[i] = ws[at];
          if (kPhase) ai[i] = ws_im[at];
        }
        mma_m16n8k8(acc[j], a, b + K / 4 * s);
        if (kPhase) mma_m16n8k8(acc_im[j], ai, b + K / 4 * s);
      }
    }
  } else {
    static_assert(R == 8 && K == 4, "float32 takes the m8n8k4 layout");
    T bb[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bb[i][k] = __shfl_sync(0xffffffffu, b[s], 4 * (2 * q + i) + k);
      }
    }
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      if (j < mtiles) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int at = (4 * s + k) * kStride + 8 * j + g;
          const T a = ws[at];
          acc[j][0] = rn_fma(a, bb[0][k], acc[j][0]);
          acc[j][1] = rn_fma(a, bb[1][k], acc[j][1]);
          if (kPhase) {
            const T ai = ws_im[at];
            acc_im[j][0] = rn_fma(ai, bb[0][k], acc_im[j][0]);
            acc_im[j][1] = rn_fma(ai, bb[1][k], acc_im[j][1]);
          }
        }
      }
    }
  }
}

// Replaces ops/interpolate.py:75 rbf_interpolate's and :53
// rbf_interpolate_phases' evaluation b @ w (B14):
// out[t, p] = sum_e phi(|x_p - c_e|) w[e, t], or, with w_im,
// atan2(sum_e phi w_im[e, t], sum_e phi w[e, t]) (interpolate.py:69-71), so
// the complex interpolant never reaches memory.
// Bound on this card: the f64 operations, P E T multiply-adds (twice for
// phases) at the tensor cores' rate, against the output's bytes; the (P, E)
// matrix is never written.
// Design: the product Out (T x P) = W^T (T x E) Phi^T (E x P) in R x 8 x K
// tiles. A block takes 8 targets a warp and a group of frames (at most MT
// tiles of R). Each lane computes phi once for its target (g = lane / 4)
// and the electrodes 4s + q, s < 16, of each chunk: its B fragments, kept in
// registers for every frame tile. The chunk's W (and W_im) rows come into
// shared memory by cp.async while phi is computed, zero past E and T, so
// padded electrodes and frames add nothing. Each lane's accumulator pairs
// lie along p; the epilogue takes atan2 for phases and stores t < T, p < P
// in the JAX layout (T, P).
template <typename T, bool kPhase, int MT>
__global__ void __launch_bounds__(32 * kEvalWarps) rbf_eval_kernel(
    const T* __restrict__ x, const T* __restrict__ c, const T* __restrict__ eps,
    const T* __restrict__ w, const T* __restrict__ w_im, T* __restrict__ out,
    int64_t n_points, int64_t n_elec, int64_t n_frames, int64_t frames_per_block,
    int kind) {
  extern __shared__ __align__(16) unsigned char eval_smem[];
  constexpr int R = eval_rows<T>(), K = eval_depth<T>();
  constexpr int kStride = eval_stride<R, MT>();
  T* ws = reinterpret_cast<T*>(eval_smem);
  T* ws_im = ws + kEvalElec * kStride;
  T* cs = ws + (kPhase ? 2 : 1) * kEvalElec * kStride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int64_t p_warp = static_cast<int64_t>(blockIdx.x) * (8 * kEvalWarps) + 8 * warp;
  const int64_t p_phi = p_warp + g;  // the target of this lane's phi
  const int64_t t0 = static_cast<int64_t>(blockIdx.y) * frames_per_block;
  const int nt = static_cast<int>(n_frames - t0 < frames_per_block ? n_frames - t0
                                                                   : frames_per_block);
  const int mtiles = (nt + R - 1) / R;
  const bool active = p_phi < n_points;
  T xp[3] = {T(0), T(0), T(0)};
  if (active) {
    xp[0] = x[3 * p_phi];
    xp[1] = x[3 * p_phi + 1];
    xp[2] = x[3 * p_phi + 2];
  }
  const T e_shape = eps[0];
  T acc[MT][R / 4], acc_im[MT][R / 4];
#pragma unroll
  for (int j = 0; j < MT; ++j) {
#pragma unroll
    for (int i = 0; i < R / 4; ++i) acc[j][i] = acc_im[j][i] = T(0);
  }
  for (int64_t e0 = 0; e0 < n_elec; e0 += kEvalElec) {
    const int ne = static_cast<int>(n_elec - e0 < kEvalElec ? n_elec - e0 : kEvalElec);
    const int steps = (ne + K - 1) / K, rows = K * steps, cols = R * mtiles;
    if (e0 > 0) __syncthreads();  // the last chunk's rows are read
    for (int k = threadIdx.x; k < rows * cols; k += blockDim.x) {
      const int e = k / cols, tl = k - e * cols;
      const int64_t src = (e0 + e) * n_frames + t0 + tl;
      if (e < ne && tl < nt) {
        cp_async(ws + e * kStride + tl, w + src);
        if (kPhase) cp_async(ws_im + e * kStride + tl, w_im + src);
      } else {
        ws[e * kStride + tl] = T(0);
        if (kPhase) ws_im[e * kStride + tl] = T(0);
      }
    }
    for (int k = threadIdx.x; k < 3 * ne; k += blockDim.x) cs[k] = c[3 * e0 + k];
    __syncthreads();  // the electrodes are in place; the rows may still fly
    T b[kEvalPhi];
#pragma unroll
    for (int s = 0; s < kEvalPhi; ++s) {
      const int e = 4 * s + q;
      b[s] = active && e < ne ? rbf_phi(pair_distance(xp, cs + 3 * e), e_shape, kind)
                              : T(0);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kEvalElec / K; ++s) {
      if (s < steps) {
        eval_step<T, kPhase, R, K, MT>(acc, acc_im, ws, ws_im, b, s, mtiles, lane);
      }
    }
  }
  const int64_t p = p_warp + 2 * q;
#pragma unroll
  for (int j = 0; j < MT; ++j) {
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      const int tl = R * j + g + 8 * (i / 2);
      const int64_t pi = p + i % 2;
      if (j < mtiles && tl < nt && pi < n_points) {
        out[(t0 + tl) * n_points + pi] = kPhase ? atan2(acc_im[j][i], acc[j][i])
                                                : acc[j][i];
      }
    }
  }
}

template <typename T, bool kPhase, int MT>
int launch_rbf_eval(const void* x, const void* c, const void* eps, const void* w,
                    const void* w_im, void* out, int64_t n_points, int64_t n_elec,
                    int64_t n_frames, int64_t kind, int64_t frames_per_block,
                    cudaStream_t stream) {
  auto kernel = rbf_eval_kernel<T, kPhase, MT>;
  constexpr size_t smem = eval_smem_bytes<T, kPhase, eval_rows<T>(), MT>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>((n_points + 8 * kEvalWarps - 1) /
                                            (8 * kEvalWarps)),
                  static_cast<unsigned int>((n_frames + frames_per_block - 1) /
                                            frames_per_block));
  kernel<<<grid, 32 * kEvalWarps, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(c), static_cast<const T*>(eps),
      static_cast<const T*>(w), static_cast<const T*>(w_im), static_cast<T*>(out),
      n_points, n_elec, n_frames, frames_per_block, static_cast<int>(kind));
  return static_cast<int>(cudaGetLastError());
}

// The frames cut into the number of groups (at most 4) nearest to 3
// blocks an SM, 6 for phases, whose two W planes and accumulators let
// fewer blocks share an SM (the launch-shape sweep of chip_smoke.py); each
// group whole R-frame tiles, at most 104 frames (112 for R = 16), held in
// the smallest of three accumulator sizes that fits.
template <typename T, bool kPhase>
int rbf_eval_frames(const void* x, const void* c, const void* eps, const void* w,
                    const void* w_im, void* out, int64_t n_points, int64_t n_elec,
                    int64_t n_frames, int64_t kind, cudaStream_t s) {
  constexpr int R = eval_rows<T>();
  constexpr int kSmall = R == 16 ? 2 : 4, kMid = R == 16 ? 4 : 7, kMax = R == 16 ? 7 : 13;
  const int64_t blocks = (n_points + 8 * kEvalWarps - 1) / (8 * kEvalWarps);
  const int64_t want = (kPhase ? 6 : 3) * static_cast<int64_t>(sm_count());
  int64_t split = (want + blocks / 2) / blocks;
  split = split < 1 ? 1 : (split > 4 ? 4 : split);
  const int64_t tiles = (n_frames + R - 1) / R;
  int64_t per = (tiles + split - 1) / split;
  per = per > kMax ? kMax : per;
  if (per <= kSmall) {
    return launch_rbf_eval<T, kPhase, kSmall>(x, c, eps, w, w_im, out, n_points, n_elec,
                                              n_frames, kind, R * per, s);
  }
  if (per <= kMid) {
    return launch_rbf_eval<T, kPhase, kMid>(x, c, eps, w, w_im, out, n_points, n_elec,
                                            n_frames, kind, R * per, s);
  }
  return launch_rbf_eval<T, kPhase, kMax>(x, c, eps, w, w_im, out, n_points, n_elec,
                                          n_frames, kind, R * per, s);
}

// The opt-in shared memory of a block on the current device, read once.
inline int64_t smem_optin() {
  static int optin = 0;
  if (optin == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (optin <= 0) optin = 48 * 1024;
  }
  return optin;
}

// K17's fit for E electrodes and R right-hand sides: kFitCols columns a
// block, in shared memory where the block's working set fits (to E = 148
// in float64, 219 in float32, on the H100), else in a slice of the
// workspace a block (L2-resident at these sizes).
struct FitLayout {
  int64_t ld, stride, blocks;
  bool shared;
};

template <typename T>
FitLayout fit_layout(int64_t n_elec, int64_t n_rhs) {
  FitLayout f{};
  f.ld = fit_ld<T>(n_elec + kFitCols);
  f.stride = fit_bytes<T>(n_elec, f.ld);
  f.shared = f.stride <= smem_optin();
  f.blocks = n_rhs > 0 ? (n_rhs + kFitCols - 1) / kFitCols : 1;
  return f;
}

template <typename T>
int64_t rbf_fit_workspace(int64_t n_elec, int64_t n_frames, int64_t n_planes) {
  if (n_elec <= 0) return 0;
  const FitLayout f = fit_layout<T>(n_elec, n_planes * n_frames);
  return f.shared ? 0 : f.blocks * f.stride;
}

template <typename T>
int rbf_fit(const void* c, const void* eps, const void* b0, const void* b1, void* w,
            void* info, void* piv, void* work, int64_t n_elec, int64_t n_frames,
            int64_t kind, double smooth, void* stream) {
  if (n_elec <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t n_rhs = (b1 != nullptr ? 2 : 1) * n_frames;
  const FitLayout f = fit_layout<T>(n_elec, n_rhs);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto kernel, size_t smem) {
    kernel<<<static_cast<unsigned int>(f.blocks), kFitThreads, smem, s>>>(
        static_cast<const T*>(c), static_cast<const T*>(eps), static_cast<const T*>(b0),
        static_cast<const T*>(b1), static_cast<T*>(w), static_cast<int32_t*>(info),
        static_cast<int32_t*>(piv), static_cast<unsigned char*>(work), n_elec, n_frames,
        n_rhs, f.ld, f.stride, static_cast<int>(kind), smooth);
  };
  if (!f.shared) {
    args(rbf_fit_kernel<T, false>, 0);
    return static_cast<int>(cudaGetLastError());
  }
  if (f.stride > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t e = cudaFuncSetAttribute(
        rbf_fit_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(f.stride));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  args(rbf_fit_kernel<T, true>, static_cast<size_t>(f.stride));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int rbf_eval(const void* x, const void* c, const void* eps, const void* w,
             const void* w_im, void* out, int64_t n_points, int64_t n_elec,
             int64_t n_frames, int64_t kind, void* stream) {
  if (n_points <= 0 || n_frames <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  return w_im != nullptr
      ? rbf_eval_frames<T, true>(x, c, eps, w, w_im, out, n_points, n_elec, n_frames,
                                 kind, s)
      : rbf_eval_frames<T, false>(x, c, eps, w, nullptr, out, n_points, n_elec, n_frames,
                                  kind, s);
}

}  // namespace mf

#define MF_FIELD_ENTRY_POINTS(SUFFIX, T)                                            \
  extern "C" int mf_wave_speed_##SUFFIX(                                            \
      const void* movie, const void* triangles, const void* grad_w,                 \
      const void* areas, const void* vertex_cells, const void* basis, void* out,    \
      int64_t n_frames, int64_t n_vert, int64_t width, double dt, int64_t output,   \
      void* stream) {                                                               \
    return mf::wave_speed<T>(movie, triangles, grad_w, areas, vertex_cells, basis,  \
                             out, n_frames, n_vert, width, dt, output, stream);     \
  }                                                                                 \
  extern "C" int64_t mf_rbf_fit_workspace_##SUFFIX(int64_t n_elec, int64_t n_frames,   \
                                                 int64_t n_planes) {                \
    return mf::rbf_fit_workspace<T>(n_elec, n_frames, n_planes);                    \
  }                                                                                 \
  extern "C" int mf_rbf_fit_##SUFFIX(const void* c, const void* eps, const void* b0,   \
                                     const void* b1, void* w, void* info, void* piv, \
                                     void* work, int64_t n_elec, int64_t n_frames,  \
                                     int64_t kind, double smooth, void* stream) {   \
    return mf::rbf_fit<T>(c, eps, b0, b1, w, info, piv, work, n_elec, n_frames, kind, \
                          smooth, stream);                                          \
  }                                                                                 \
  extern "C" int mf_rbf_eval_##SUFFIX(const void* x, const void* c, const void* eps, \
                                      const void* w, const void* w_im, void* out,   \
                                      int64_t n_points, int64_t n_elec,             \
                                      int64_t n_frames, int64_t kind, void* stream) { \
    return mf::rbf_eval<T>(x, c, eps, w, w_im, out, n_points, n_elec, n_frames,     \
                           kind, stream);                                           \
  }

MF_FIELD_ENTRY_POINTS(f32, float)
MF_FIELD_ENTRY_POINTS(f64, double)
