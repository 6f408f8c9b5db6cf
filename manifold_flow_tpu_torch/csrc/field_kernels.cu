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

// Replaces ops/wavespeed.py:28 vertex_gradients, :52
// tangential_gradient_magnitude, :64 wave_velocity_amplitude, :72
// wave_velocity_phase (and :79's abs / 1000) with ops/phase.py:66 and :78's
// temporal derivatives (B13), in one pass.
// Bound on this card: bytes. The function reads the movie once and writes
// one value (or vector) per (frame, vertex), plus the mesh tables once; the
// re-reads of each cell's three corners and tables (six cells a vertex) come
// from L2, which holds the whole problem at the bench sizes (2.4 MB movie).
// Design: one thread per (frame, vertex), the vertex fastest, so the
// movie's reads and the output's writes coalesce across a warp; each thread
// walks its vertex_cells row in slot order, forms each cell's gradient in
// the JAX einsum's corner order, weights it by the area and accumulates the
// sum and the total area, divides (den > 0, else 1), then projects onto the
// tangent plane and expresses on the basis as geometry/tangent.py does; the
// temporal derivative reads movie[t +- 1, v] (and t +- 2 at the amplitude
// method's ends). No intermediate (T, M, 3) or (T, N, 3) reaches memory.
template <typename T>
__global__ void wave_speed_kernel(
    const T* __restrict__ movie, const int32_t* __restrict__ triangles,
    const T* __restrict__ grad_w, const T* __restrict__ areas,
    const int32_t* __restrict__ vertex_cells, const T* __restrict__ basis,
    T* __restrict__ out, int64_t n_frames, int64_t n_vert, int64_t width,
    double dt, int output) {
  const int64_t i = global_index();
  if (i >= n_frames * n_vert) return;
  const int64_t t = i / n_vert, v = i - t * n_vert;
  const T* frame = movie + t * n_vert;
  T num[3] = {T(0), T(0), T(0)};
  T den = T(0);
  for (int64_t s = 0; s < width; ++s) {
    const int32_t m = vertex_cells[v * width + s];
    if (m < 0) continue;
    const T i0 = frame[triangles[3 * m]], i1 = frame[triangles[3 * m + 1]],
            i2 = frame[triangles[3 * m + 2]];
    const T* gw = grad_w + 9 * static_cast<int64_t>(m);
    const T a = areas[m];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const T g = rn_add(rn_add(rn_mul(i0, gw[d]), rn_mul(i1, gw[3 + d])),
                         rn_mul(i2, gw[6 + d]));
      num[d] = rn_add(num[d], rn_mul(g, a));
    }
    den = rn_add(den, a);
  }
  const T scale = den > T(0) ? den : T(1);
  T g[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) g[d] = rn_div(num[d], scale);
  if (output == kGradient) {
#pragma unroll
    for (int d = 0; d < 3; ++d) out[3 * i + d] = g[d];
    return;
  }
  // geometry/tangent.py: project_to_plane, then express_on_basis.
  const T* e = basis + 6 * v;
  const T e1[3] = {e[0], e[1], e[2]}, e2[3] = {e[3], e[4], e[5]};
  T n[3];
  cross3(e1, e2, n);
  const T nn = dot3(n, n);
  const T vn = rn_div(dot3(g, n), nn > T(0) ? nn : T(1));
  const T along = nn > T(0) ? vn : T(0);
  T p[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) p[d] = rn_sub(g[d], rn_mul(along, n[d]));
  const T ca = rn_div(dot3(p, e1), dot3(e1, e1));
  const T cb = rn_div(dot3(p, e2), dot3(e2, e2));
  const T mag = rn_sqrt(rn_add(rn_mul(ca, ca), rn_mul(cb, cb)));
  if (output == kMagnitude) {
    out[i] = mag;
    return;
  }
  const T* mv = movie + v;
  const int64_t last = n_frames - 1;
  T dtime;
  if (output == kAmplitude) {
    // np.gradient(edge_order=2): one-sided second-order stencils at the ends.
    if (t == 0) {
      dtime = rn_div(rn_sub(rn_add(rn_mul(T(-3), mv[0]), rn_mul(T(4), mv[n_vert])),
                            mv[2 * n_vert]), T(2));
    } else if (t == last) {
      dtime = rn_div(rn_add(rn_sub(rn_mul(T(3), mv[last * n_vert]),
                                   rn_mul(T(4), mv[(last - 1) * n_vert])),
                            mv[(last - 2) * n_vert]), T(2));
    } else {
      dtime = rn_div(rn_sub(mv[(t + 1) * n_vert], mv[(t - 1) * n_vert]), T(2));
    }
    dtime = rn_div(dtime, T(dt));
  } else if (t == 0) {
    dtime = rn_div(angle_subtract(mv[n_vert], mv[0]), T(dt));
  } else if (t == last) {
    dtime = rn_div(angle_subtract(mv[last * n_vert], mv[(last - 1) * n_vert]), T(dt));
  } else {
    dtime = rn_div(angle_subtract(mv[(t + 1) * n_vert], mv[(t - 1) * n_vert]),
                   T(2.0 * dt));
  }
  T speed = rn_div(dtime, mag);
  if (output == kPhaseMmPerMs) speed = rn_div(fabs(speed), T(1000));
  out[i] = speed;
}

template <typename T>
int wave_speed(const void* movie, const void* triangles, const void* grad_w,
               const void* areas, const void* vertex_cells, const void* basis, void* out,
               int64_t n_frames, int64_t n_vert, int64_t width, double dt, int64_t output,
               void* stream) {
  const int64_t total = n_frames * n_vert;
  if (total > 0) {
    wave_speed_kernel<T><<<blocks_for(total), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(movie), static_cast<const int32_t*>(triangles),
        static_cast<const T*>(grad_w), static_cast<const T*>(areas),
        static_cast<const int32_t*>(vertex_cells), static_cast<const T*>(basis),
        static_cast<T*>(out), n_frames, n_vert, width, dt, static_cast<int>(output));
  }
  return static_cast<int>(cudaGetLastError());
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

constexpr int kEvalTargets = 128;  // targets (threads) per block
constexpr int kEvalFrames = 16;    // frames per block: accumulators per thread
constexpr int kEvalElec = 64;      // electrodes staged in shared memory at once

// Replaces ops/interpolate.py:75 rbf_interpolate's and :53
// rbf_interpolate_phases' evaluation b @ w (B14):
// out[t, p] = sum_e phi(|x_p - c_e|) w[e, t], or, with w_im,
// atan2(sum_e phi w_im[e, t], sum_e phi w[e, t]) (interpolate.py:69-71), so
// the complex interpolant never reaches memory.
// Bound on this card: the f64 operations, P E T multiply-adds (twice for
// phases), against the output's bytes; the (P, E) matrix is never written.
// Design: one block per tile of kEvalTargets targets and kEvalFrames frames;
// the electrodes and their weights for the block's frames are staged in
// shared memory kEvalElec at a time; each thread computes phi for its target
// and each electrode once and reuses it across the block's frames, summing
// the electrodes in ascending order, and writes each frame's value in the
// JAX layout (T, P), coalesced across the block.
template <typename T, bool kPhase>
__global__ void __launch_bounds__(kEvalTargets) rbf_eval_kernel(
    const T* __restrict__ x, const T* __restrict__ c, const T* __restrict__ eps,
    const T* __restrict__ w, const T* __restrict__ w_im, T* __restrict__ out,
    int64_t n_points, int64_t n_elec, int64_t n_frames, int kind) {
  __shared__ T cs[kEvalElec * 3];
  __shared__ T ws[kEvalElec * kEvalFrames];
  __shared__ T ws_im[kPhase ? kEvalElec * kEvalFrames : 1];
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kEvalTargets + threadIdx.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.y) * kEvalFrames;
  const bool active = p < n_points;
  T xp[3] = {T(0), T(0), T(0)};
  if (active) {
    xp[0] = x[3 * p];
    xp[1] = x[3 * p + 1];
    xp[2] = x[3 * p + 2];
  }
  const T e_shape = eps[0];
  T acc[kEvalFrames], acc_im[kPhase ? kEvalFrames : 1];
#pragma unroll
  for (int j = 0; j < kEvalFrames; ++j) acc[j] = T(0);
#pragma unroll
  for (int j = 0; j < (kPhase ? kEvalFrames : 1); ++j) acc_im[j] = T(0);
  for (int64_t e0 = 0; e0 < n_elec; e0 += kEvalElec) {
    const int64_t ne = n_elec - e0 < kEvalElec ? n_elec - e0 : kEvalElec;
    for (int k = threadIdx.x; k < ne * 3; k += kEvalTargets) cs[k] = c[3 * e0 + k];
    for (int k = threadIdx.x; k < ne * kEvalFrames; k += kEvalTargets) {
      const int64_t e = k / kEvalFrames, t = t0 + (k - e * kEvalFrames);
      const bool in = t < n_frames;
      ws[k] = in ? w[(e0 + e) * n_frames + t] : T(0);
      if (kPhase) ws_im[k] = in ? w_im[(e0 + e) * n_frames + t] : T(0);
    }
    __syncthreads();
    if (active) {
      for (int64_t e = 0; e < ne; ++e) {
        const T phi = rbf_phi(pair_distance(xp, cs + 3 * e), e_shape, kind);
        const T* we = ws + e * kEvalFrames;
#pragma unroll
        for (int j = 0; j < kEvalFrames; ++j) acc[j] += phi * we[j];
        if (kPhase) {
          const T* wi = ws_im + e * kEvalFrames;
#pragma unroll
          for (int j = 0; j < kEvalFrames; ++j) acc_im[j] += phi * wi[j];
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < kEvalFrames; ++j) {
    const int64_t t = t0 + j;
    if (t < n_frames) {
      out[t * n_points + p] = kPhase ? atan2(acc_im[kPhase ? j : 0], acc[j]) : acc[j];
    }
  }
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
  if (n_points > 0 && n_frames > 0) {
    const dim3 grid(static_cast<unsigned int>((n_points + kEvalTargets - 1) / kEvalTargets),
                    static_cast<unsigned int>((n_frames + kEvalFrames - 1) / kEvalFrames));
    const auto s = static_cast<cudaStream_t>(stream);
    if (w_im != nullptr) {
      rbf_eval_kernel<T, true><<<grid, kEvalTargets, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(c), static_cast<const T*>(eps),
          static_cast<const T*>(w), static_cast<const T*>(w_im), static_cast<T*>(out),
          n_points, n_elec, n_frames, static_cast<int>(kind));
    } else {
      rbf_eval_kernel<T, false><<<grid, kEvalTargets, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(c), static_cast<const T*>(eps),
          static_cast<const T*>(w), nullptr, static_cast<T*>(out), n_points, n_elec,
          n_frames, static_cast<int>(kind));
    }
  }
  return static_cast<int>(cudaGetLastError());
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
