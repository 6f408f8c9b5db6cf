// Kernels of the field stages: K16, the wave speeds of S5 (with the spatial
// gradients they divide by), and K17, the RBF interpolation of S2 (its
// system matrix and its evaluation at the surface's vertices).
// Layouts follow the JAX package (TriMesh tables, ops/interpolate.py):
//   movie         (T, N)      amplitude or phase movie
//   triangles     (M, 3)      int32 corner vertex ids
//   grad_w        (M, 3, 3)   P1 hat gradients per corner
//   areas         (M,)        triangle areas
//   vertex_cells  (N, C)      int32 incident cells, ascending, -1 padded
//   basis         (N, 2, 3)   tangent bases (e1, e2)
//   c             (E, 3)      the electrodes; x (P, 3) the evaluation points
//   eps           (1,)        the RBF shape parameter, on the device
//   w, w_im       (E, T)      RBF weights per frame (real, imaginary part)
// The C entry points return the cudaError_t of the launch.
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

// Replaces ops/interpolate.py:93 _rbf_solve's system matrix (B14):
// out[i, j] = phi(|c_i - c_j|) - smooth * [i == j], the E x E matrix
// A - smooth I of the electrodes c.
// Bound: bytes of the output at these sizes (E x E is 32 KB at E = 64).
// Design: one thread per entry, the column fastest.
template <typename T>
__global__ void rbf_basis_kernel(const T* __restrict__ c, const T* __restrict__ eps,
                                 T* __restrict__ out, int64_t n_elec, int kind,
                                 double smooth) {
  const int64_t k = global_index();
  if (k >= n_elec * n_elec) return;
  const int64_t i = k / n_elec, j = k - i * n_elec;
  const T phi = rbf_phi(pair_distance(c + 3 * i, c + 3 * j), eps[0], kind);
  out[k] = i == j ? rn_sub(phi, T(smooth)) : phi;
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

template <typename T>
int rbf_basis(const void* c, const void* eps, void* out, int64_t n_elec, int64_t kind,
              double smooth, void* stream) {
  const int64_t total = n_elec * n_elec;
  if (total > 0) {
    rbf_basis_kernel<T><<<blocks_for(total), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(c), static_cast<const T*>(eps), static_cast<T*>(out),
        n_elec, static_cast<int>(kind), smooth);
  }
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
  extern "C" int mf_rbf_basis_##SUFFIX(const void* c, const void* eps, void* out,    \
                                       int64_t n_elec, int64_t kind, double smooth, \
                                       void* stream) {                              \
    return mf::rbf_basis<T>(c, eps, out, n_elec, kind, smooth, stream);             \
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
