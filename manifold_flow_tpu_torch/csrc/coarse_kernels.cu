// Two-level preconditioner kernels (K8-K11) of solve/coarse.py.
//
// K8  coarse_assemble:    the dense coarse matrices A_c = P^T (a1_k + lambda
//                         a2) P (solve/coarse.py:281 coarse_matrices, B6).
// K9  coarse_restrict:    rc = P^T r        (solve/coarse.py:254-266, B7)
// K10 coarse_gemv:        yc = A_c^-1 rc    (solve/coarse.py:267-271, B7)
// K11 coarse_prolong_dot: z += P yc, then rz = <r, z>
//                         (solve/coarse.py:272-278 and solve/cg.py:97-98)
//
// Layouts: vectors are (T, 2N) with dof = vertex + N * alpha; the coarse
// vectors are (T, 2Nc) with coarse dof = 2 * aggregate + component; r_blk is
// (N, 2, 2) with R_v[a][b] = e_v^a . ebar^b at 4v + 2a + b. Every sum runs in
// a fixed order (each lane strides through an entry's CSR list or an
// aggregate's members, then the fixed-order warp and block reductions of
// common.cuh close it): no float atomics, so the refined solve's iteration
// counts repeat run to run.
//
// What bounds them on the H100, in f32 at the 12.5k-vertex shapes (T = 97
// frames, M = 24642 triangles, N = 12544 vertices, Nc = 196 aggregates of up
// to K = 64 members, 2Nc = 392):
//   K8  once per solve: ~180 MB of device memory (g 57 MB, the zeroed and
//       written dense (T, 392, 392) output 2 x 60 MB, the CSR 3.5 MB), but
//       more of L2: each (frame, entry) gathers g, R and the CSR for its
//       ~176 contributions, ~57 MB of L2 reads per frame. The design keeps
//       the (T, M, 36) contributions (344 MB) out of memory altogether and
//       forms each one in registers, a warp per (frame, entry) so that the
//       gathers of 32 contributions are in flight at once.
//   K9  per PCG iteration: reads r (9.7 MB); a warp per (frame, aggregate)
//       reads its up-to-64 members together (a thread per aggregate would
//       leave 97 x 196 threads walking them one load at a time).
//   K10 per PCG iteration: reads A_c^-1 (60 MB, 119 MB in f64), the largest
//       read of an iteration; a warp per row reads it coalesced, once.
//   K11 per PCG iteration: reads z and r and writes z (29 MB); one block
//       per frame so the dot product closes in the same pass.
#include "common.cuh"

namespace mf {

// A triangle-local coarse contribution s = m * 36 + l * 6 + l2, with local
// DOFs l = c * 2 + x and l2 = c2 * 2 + y (corner, coarse component).
struct Contribution {
  int64_t m;
  int c, x, c2, y;
};

__device__ __forceinline__ Contribution decode(int s) {
  const int l = (s % 36) / 6;
  const int l2 = s % 6;
  return {s / 36, l >> 1, l & 1, l2 >> 1, l2 & 1};
}

// (Rg)_c^x = sum_a g_c^a R_c[a][x]: the a1 factor of corner c projected on
// the coarse basis of its aggregate (solve/coarse.py:318).
template <typename T>
__device__ __forceinline__ T coarse_factor(const T* gm, const T* r, int c,
                                           int x) {
  return gm[2 * c] * r[x] + gm[2 * c + 1] * r[2 + x];
}

// K8, phase 1: the frame-independent a2 part of every non-zero coarse entry,
// a2c[e] = sum over the entry's contributions of
// sum_{a,b} R_c[a][x] B2[(c,a),(c2,b)] R_c2[b][y] (solve/coarse.py:299-304);
// one warp per entry, as in phase 2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    coarse_a2_kernel(const T* __restrict__ blocks2, const T* __restrict__ r_blk,
                     const int* __restrict__ triangles,
                     const int* __restrict__ ptr, const int* __restrict__ src,
                     T* __restrict__ a2c, int64_t nnz) {
  const int64_t e = global_index() >> 5;
  const int lane = threadIdx.x & 31;
  if (e >= nnz) return;  // uniform across the warp
  T acc = T(0);
  for (int k = ptr[e] + lane; k < ptr[e + 1]; k += 32) {
    const Contribution q = decode(src[k]);
    const T* rc = r_blk + 4 * static_cast<int64_t>(triangles[3 * q.m + q.c]);
    const T* rd = r_blk + 4 * static_cast<int64_t>(triangles[3 * q.m + q.c2]);
    const T* b = blocks2 + 36 * q.m + (2 * q.c) * 6 + 2 * q.c2;
    T v = T(0);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        v += rc[2 * a + q.x] * b[a * 6 + bb] * rd[2 * bb + q.y];
      }
    }
    acc += v;
  }
  acc = warp_sum(acc);
  if (lane == 0) a2c[e] = acc;
}

// K8, phase 2: out[t][dst[e]] = a1c[t][e] + lambda * a2c[e], with
// a1c[t][e] the sum over the entry's contributions of
// w_cc2 (Rg)_c^x (Rg)_c2^y, w = (A/12)(1 + delta_cc2) (solve/coarse.py:318-
// 330). One warp per (frame, entry): lane l adds the entry's contributions
// l, l + 32, ... and the fixed-order warp sum closes it; in 'mean' mode one
// warp per entry sums every frame and divides by their count (one shared
// matrix).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    coarse_a1_kernel(const T* __restrict__ g, const T* __restrict__ r_blk,
                     const int* __restrict__ triangles,
                     const T* __restrict__ w_scale, const int* __restrict__ ptr,
                     const int* __restrict__ src, const int* __restrict__ dst,
                     const T* __restrict__ a2c, T lambda, T* __restrict__ out,
                     int64_t n_frames, int64_t m_tri, int64_t nnz,
                     int64_t nc2sq, int mean) {
  const int64_t e = global_index() >> 5;
  const int lane = threadIdx.x & 31;
  if (e >= nnz) return;  // uniform across the warp
  const int64_t t = blockIdx.y;
  const int64_t f0 = mean ? 0 : t;
  const int64_t f1 = mean ? n_frames : t + 1;
  T acc = T(0);
  for (int k = ptr[e] + lane; k < ptr[e + 1]; k += 32) {
    const Contribution q = decode(src[k]);
    const T* rc = r_blk + 4 * static_cast<int64_t>(triangles[3 * q.m + q.c]);
    const T* rd = r_blk + 4 * static_cast<int64_t>(triangles[3 * q.m + q.c2]);
    const T w = (q.c == q.c2 ? T(2) : T(1)) * w_scale[q.m];
    T s = T(0);
    for (int64_t f = f0; f < f1; ++f) {
      const T* gm = g + (f * m_tri + q.m) * 6;
      s += coarse_factor(gm, rc, q.c, q.x) * coarse_factor(gm, rd, q.c2, q.y);
    }
    acc += s * w;
  }
  acc = warp_sum(acc);
  if (lane != 0) return;
  if (mean) acc /= static_cast<T>(n_frames);
  out[t * nc2sq + dst[e]] = acc + lambda * a2c[e];
}

// K9: rc[t][2a + b] = sum over the members v of aggregate a (the pad index N
// skipped) of sum_a' R_v[a'][b] r[t][v + N a']; one warp per (frame,
// aggregate), lane l taking members l, l + 32, ..., then the warp sum.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    restrict_kernel(const T* __restrict__ r, const T* __restrict__ r_blk,
                    const int* __restrict__ members, T* __restrict__ rc,
                    int64_t n_vert, int64_t n_coarse, int64_t k_width) {
  const int64_t a = global_index() >> 5;
  const int lane = threadIdx.x & 31;
  if (a >= n_coarse) return;  // uniform across the warp
  const int64_t t = blockIdx.y;
  const T* rt = r + t * 2 * n_vert;
  T acc0 = T(0), acc1 = T(0);
  for (int64_t k = lane; k < k_width; k += 32) {
    const int64_t v = members[a * k_width + k];
    if (v == n_vert) continue;
    const T* rv = r_blk + 4 * v;
    const T r1 = rt[v];
    const T r2 = rt[v + n_vert];
    acc0 += rv[0] * r1 + rv[2] * r2;
    acc1 += rv[1] * r1 + rv[3] * r2;
  }
  acc0 = warp_sum(acc0);
  acc1 = warp_sum(acc1);
  if (lane == 0) {
    rc[t * 2 * n_coarse + 2 * a] = acc0;
    rc[t * 2 * n_coarse + 2 * a + 1] = acc1;
  }
}

// K10: y[t] = A[t] x[t] for (n, n) matrices, one warp per (frame, row). A
// frame stride of 0 applies one shared matrix to every frame.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gemv_kernel(const T* __restrict__ a, const T* __restrict__ x,
                T* __restrict__ y, int64_t n, int64_t a_stride,
                int64_t n_rows) {
  const int64_t warp = global_index() >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_rows) return;  // uniform across the warp
  const int64_t t = warp / n;
  const int64_t row = warp % n;
  const T* ar = a + t * a_stride + row * n;
  const T* xt = x + t * n;
  T acc = T(0);
  for (int64_t j = lane; j < n; j += 32) acc += ar[j] * xt[j];
  acc = warp_sum(acc);
  if (lane == 0) y[t * n + row] = acc;
}

// K11: z[t][v + N a] += sum_b R_v[a][b] yc[t][2 agg[v] + b], then
// rz[t] = <r_t, z_t>; one block per frame.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    prolong_dot_kernel(T* __restrict__ z, const T* __restrict__ r,
                       const T* __restrict__ yc, const T* __restrict__ r_blk,
                       const int* __restrict__ agg, T* __restrict__ rz,
                       int64_t n_vert, int64_t n_coarse) {
  __shared__ T scratch[kWarps];
  const int64_t t = blockIdx.x;
  T* zt = z + t * 2 * n_vert;
  const T* rt = r + t * 2 * n_vert;
  const T* yt = yc + t * 2 * n_coarse;
  T acc = T(0);
  for (int64_t v = threadIdx.x; v < n_vert; v += kThreads) {
    const int64_t w = v + n_vert;
    const int64_t i = agg[v];
    const T ya = yt[2 * i];
    const T yb = yt[2 * i + 1];
    const T* rv = r_blk + 4 * v;
    const T z1 = zt[v] + (rv[0] * ya + rv[1] * yb);
    const T z2 = zt[w] + (rv[2] * ya + rv[3] * yb);
    zt[v] = z1;
    zt[w] = z2;
    acc += rt[v] * z1 + rt[w] * z2;
  }
  acc = block_sum(acc, scratch);
  if (threadIdx.x == 0) rz[t] = acc;
}

constexpr int64_t kMaxGridY = 65535;

template <typename T>
int coarse_assemble(const void* g, const void* blocks2, const void* r_blk,
                    const void* triangles, const void* w_scale,
                    const void* ptr, const void* src, const void* dst,
                    double lambda, void* a2c, void* out, int64_t n_frames,
                    int64_t m_tri, int64_t nnz, int64_t nc2, int64_t mean,
                    void* stream) {
  const int64_t out_frames = mean ? 1 : n_frames;
  if (out_frames > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  if (nnz > 0 && n_frames > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    coarse_a2_kernel<T><<<blocks_for(nnz * 32), kThreads, 0, s>>>(
        static_cast<const T*>(blocks2), static_cast<const T*>(r_blk),
        static_cast<const int*>(triangles), static_cast<const int*>(ptr),
        static_cast<const int*>(src), static_cast<T*>(a2c), nnz);
    const dim3 grid(blocks_for(nnz * 32), static_cast<unsigned int>(out_frames));
    coarse_a1_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(g), static_cast<const T*>(r_blk),
        static_cast<const int*>(triangles), static_cast<const T*>(w_scale),
        static_cast<const int*>(ptr), static_cast<const int*>(src),
        static_cast<const int*>(dst), static_cast<const T*>(a2c),
        static_cast<T>(lambda), static_cast<T*>(out), n_frames, m_tri, nnz,
        nc2 * nc2, static_cast<int>(mean != 0));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int coarse_restrict(const void* r, const void* r_blk, const void* members,
                    void* rc, int64_t n_frames, int64_t n_vert,
                    int64_t n_coarse, int64_t k_width, void* stream) {
  if (n_frames > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  if (n_frames > 0 && n_coarse > 0) {
    const dim3 grid(blocks_for(n_coarse * 32),
                    static_cast<unsigned int>(n_frames));
    restrict_kernel<T><<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(r), static_cast<const T*>(r_blk),
        static_cast<const int*>(members), static_cast<T*>(rc), n_vert,
        n_coarse, k_width);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int coarse_gemv(const void* a, const void* x, void* y, int64_t n_frames,
                int64_t n, int64_t a_stride, void* stream) {
  const int64_t n_rows = n_frames * n;
  if (n_rows > 0) {
    gemv_kernel<T><<<blocks_for(n_rows * 32), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(a), static_cast<const T*>(x),
        static_cast<T*>(y), n, a_stride, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int coarse_prolong_dot(void* z, const void* r, const void* yc,
                       const void* r_blk, const void* agg, void* rz,
                       int64_t n_frames, int64_t n_vert, int64_t n_coarse,
                       void* stream) {
  if (n_frames > 0) {
    prolong_dot_kernel<T><<<static_cast<unsigned int>(n_frames), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<T*>(z), static_cast<const T*>(r),
        static_cast<const T*>(yc), static_cast<const T*>(r_blk),
        static_cast<const int*>(agg), static_cast<T*>(rz), n_vert, n_coarse);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mf

#define MF_COARSE_ENTRY_POINTS(SUFFIX, T)                                      \
  extern "C" int mf_coarse_assemble_##SUFFIX(                                  \
      const void* g, const void* blocks2, const void* r_blk,                   \
      const void* triangles, const void* w_scale, const void* ptr,             \
      const void* src, const void* dst, double lambda, void* a2c, void* out,   \
      int64_t n_frames, int64_t m_tri, int64_t nnz, int64_t nc2, int64_t mean, \
      void* stream) {                                                          \
    return mf::coarse_assemble<T>(g, blocks2, r_blk, triangles, w_scale, ptr,  \
                                  src, dst, lambda, a2c, out, n_frames, m_tri, \
                                  nnz, nc2, mean, stream);                     \
  }                                                                            \
  extern "C" int mf_coarse_restrict_##SUFFIX(                                  \
      const void* r, const void* r_blk, const void* members, void* rc,         \
      int64_t n_frames, int64_t n_vert, int64_t n_coarse, int64_t k_width,     \
      void* stream) {                                                          \
    return mf::coarse_restrict<T>(r, r_blk, members, rc, n_frames, n_vert,     \
                                  n_coarse, k_width, stream);                  \
  }                                                                            \
  extern "C" int mf_coarse_gemv_##SUFFIX(const void* a, const void* x,         \
                                         void* y, int64_t n_frames, int64_t n, \
                                         int64_t a_stride, void* stream) {     \
    return mf::coarse_gemv<T>(a, x, y, n_frames, n, a_stride, stream);         \
  }                                                                            \
  extern "C" int mf_coarse_prolong_dot_##SUFFIX(                               \
      void* z, const void* r, const void* yc, const void* r_blk,               \
      const void* agg, void* rz, int64_t n_frames, int64_t n_vert,             \
      int64_t n_coarse, void* stream) {                                        \
    return mf::coarse_prolong_dot<T>(z, r, yc, r_blk, agg, rz, n_frames,       \
                                     n_vert, n_coarse, stream);                \
  }

MF_COARSE_ENTRY_POINTS(f32, float)
MF_COARSE_ENTRY_POINTS(f64, double)
