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
//   K9  per PCG iteration: reads r (9.7 MB, 3.0 us at 3.35 TB/s), gathered
//       by member. Its first design ran a warp per (frame, aggregate): the
//       frame-independent members (50 KB) and R_v (200 KB) came again from
//       L2 for each of the 97 frames (~24 MB), and each lane had one
//       dependent chain (member id, then r) in flight. This design gives a
//       warp one aggregate for kRestrictFrames frames: the ids and R_v load
//       once, then every frame's r loads go out together. See
//       restrict_kernel.
//   K10 per PCG iteration: reads A_c^-1 (60 MB, 119 MB in f64, both beyond
//       the 50 MB L2), the largest read of an iteration: 17.9 / 35.8 us at
//       3.35 TB/s. Its first design ran a warp per row in 4- or 8-byte
//       loads, one in flight a lane: a 392-value row took 13 warp steps,
//       the last with 8 of 32 lanes (28 us a launch in f32, in the solve).
//       In float32 with a matrix per frame (the two-level solve's case)
//       this design keeps a warp per row but streams it in 16-byte
//       vectors, a lane's share of the row (up to 16 values) loaded before
//       its multiply-adds; float64 and a shared matrix keep the first
//       design. See gemv_kernel.
//   K11 per PCG iteration: reads z and r and writes z (29 MB, 8.8 us). Its
//       first design ran one block a frame (97 blocks on 132 SMs), each
//       thread walking ~49 vertices with 4-byte loads. This design runs S
//       blocks a frame with 16-byte loads, as pcg_update does, and closes
//       r.z through the same slice-order closing (common.cuh
//       close_slices). See prolong_dot_kernel.
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
// skipped) of sum_a' R_v[a'][b] r[t][v + N a']. A warp owns aggregate a for
// F consecutive frames: lane l takes members l, l + 32, ..., kRestrictMembers
// of them at a time, loads their ids and R_v once, then issues r[t][v] and
// r[t][v + N] for all F frames before the multiply-adds (F x 4 loads in
// flight a lane where one chain stood). Each frame's lane sum adds the
// members in the same order as a warp per (frame, aggregate) would, then the
// fixed-order warp sum closes it: rc is bitwise that design's. F is 4 in
// f32 and 2 in f64, the fastest of 1, 2, 4 and 8 on the card at the 12.5k
// shapes (f32: 5.8, 5.1, 5.0, 5.3-5.6 us; f64: 8.7, 7.3, 7.9, 9.1).
constexpr int kRestrictMembers = 2;  // members a lane holds at once (64 a warp)
template <typename T>
constexpr int kRestrictFrames = 16 / static_cast<int>(sizeof(T));  // F

// R_v (4 values at r_blk + 4v) into q: one 16-byte load (two in f64) where
// r_blk is 16-byte aligned, else one value a load.
__device__ __forceinline__ void load_block(const float* rb, bool aligned, float* q) {
  if (aligned) {
    unpack(__ldg(reinterpret_cast<const float4*>(rb)), q);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = __ldg(rb + i);
  }
}
__device__ __forceinline__ void load_block(const double* rb, bool aligned, double* q) {
  if (aligned) {
    unpack(__ldg(reinterpret_cast<const double2*>(rb)), q);
    unpack(__ldg(reinterpret_cast<const double2*>(rb) + 1), q + 2);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = __ldg(rb + i);
  }
}

template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
    restrict_kernel(const T* __restrict__ r, const T* __restrict__ r_blk,
                    const int* __restrict__ members, T* __restrict__ rc,
                    int64_t n_frames, int64_t n_vert, int64_t n_coarse,
                    int64_t k_width) {
  constexpr int M = kRestrictMembers;
  const int64_t a = global_index() >> 5;
  const int lane = threadIdx.x & 31;
  if (a >= n_coarse) return;  // uniform across the warp
  const int64_t t0 = static_cast<int64_t>(blockIdx.y) * F;
  const bool aligned = (reinterpret_cast<uintptr_t>(r_blk) & 15) == 0;
  const int* ma = members + a * k_width;
  T acc0[F], acc1[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc0[f] = acc1[f] = T(0);
  for (int64_t k0 = lane; k0 < k_width; k0 += 32 * M) {
    int64_t v[M];
    T q[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int64_t k = k0 + 32 * m;
      v[m] = k < k_width ? __ldg(ma + k) : n_vert;
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (v[m] != n_vert) load_block(r_blk + 4 * v[m], aligned, q[m]);
    }
    T x1[F][M] = {}, x2[F][M] = {};
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const T* rt = r + (t0 + f) * 2 * n_vert;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if (t0 + f < n_frames && v[m] != n_vert) {
          x1[f][m] = __ldg(rt + v[m]);
          x2[f][m] = __ldg(rt + v[m] + n_vert);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if (v[m] == n_vert) continue;
        const T* rv = q[m];
        const T r1 = x1[f][m];
        const T r2 = x2[f][m];
        acc0[f] += rv[0] * r1 + rv[2] * r2;
        acc1[f] += rv[1] * r1 + rv[3] * r2;
      }
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    acc0[f] = warp_sum(acc0[f]);
    acc1[f] = warp_sum(acc1[f]);
  }
  if (lane != 0) return;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    if (t0 + f < n_frames) {
      rc[(t0 + f) * 2 * n_coarse + 2 * a] = acc0[f];
      rc[(t0 + f) * 2 * n_coarse + 2 * a + 1] = acc1[f];
    }
  }
}

// K10: y[t] = A[t] x[t] for (n, n) matrices, a warp per (frame, row). A
// frame stride of 0 applies one shared matrix to every frame (its rows then
// come from L2).
//
// float64, and a shared matrix in either type, run gemv_kernel, one value a
// lane a step. float32 with a matrix per frame runs gemv_vectors_kernel,
// which streams the row in 16-byte vectors, each lane loading kGemvVectors
// of them (16 values, a whole 392-value row per warp) before their
// multiply-adds. On the card the batch made the other two cases slower:
// float64 gains no bytes in flight a load, and a shared matrix comes from
// L2. The fixed-order warp sum closes each row, so repeated calls are
// bitwise equal. Tried on the card and slower at the 12.5k shapes: a block
// per (frame, rows) with x staged in shared memory (also with the rows'
// loads issued before the staging), a TMA ring of row chunks, two rows a
// warp, x in 16-byte loads where aligned.
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

constexpr int kGemvVectors = 4;

// One 16-byte vector's worth of values from p, one value a load (x's rows
// need not share the matrix row's 16-byte phase).
__device__ __forceinline__ float4 ldg_values(const float* p) {
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// A row starts 16 bytes aligned or not (a frame's matrix starts aligned
// whenever the tensor does, since n is even, but row r starts at r n
// elements, 8 bytes past a boundary for odd r when n = 2 mod 4): the values
// before its first boundary and after its last whole vector go one a lane.
// A is read once a solve iteration and is larger than L2, so it is loaded
// evict-first (__ldcs): its lines, not the ones the iteration's other
// kernels left dirty, make room for the stream, and no write-back falls
// inside K10. x is read through the read-only cache. The launch bounds
// ask for one block an SM at least, which lets nvcc keep the whole batch in
// registers (left to itself it took fewer and the kernel ran slower on the
// card).
__global__ void __launch_bounds__(kThreads, 1)
    gemv_vectors_kernel(const float* __restrict__ a, const float* __restrict__ x,
                        float* __restrict__ y, int64_t n, int64_t a_stride,
                        int64_t n_rows) {
  constexpr int W = kVecWidth<float>;
  constexpr int U = kGemvVectors;
  const int64_t warp = global_index() >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_rows) return;  // uniform across the warp
  const int64_t t = warp / n;
  const int64_t row = warp % n;
  const float* ar = a + t * a_stride + row * n;
  const float* xt = x + t * n;
  const int64_t head = head_to_16(ar, n);
  const int64_t n_vec = (n - head) / W;
  const float4* av = reinterpret_cast<const float4*>(ar + head);
  const float* xh = xt + head;
  float part[U] = {};
  for (int64_t k0 = lane; k0 < n_vec; k0 += 32 * U) {
    float4 m[U] = {};
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + 32 * u < n_vec) m[u] = __ldcs(av + k0 + 32 * u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t k = k0 + 32 * u;
      if (k < n_vec) part[u] = dot_acc(m[u], ldg_values(xh + k * W), part[u]);
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int u = 0; u < U; ++u) acc += part[u];
  if (lane < head) acc = dot_acc(__ldg(ar + lane), __ldg(xt + lane), acc);
  const int64_t tail = head + n_vec * W + lane;
  if (tail < n) acc = dot_acc(__ldg(ar + tail), __ldg(xt + tail), acc);
  acc = warp_sum(acc);
  if (lane == 0) y[t * n + row] = acc;
}

// K11: z[t][v + N a] += sum_b R_v[a][b] yc[t][2 agg[v] + b], then
// rz[t] = <r_t, z_t>. Block (s, t) takes slice s of frame t (and of every
// gridDim.y-th frame after it), as pcg_update's blocks do. When z's and r's
// rows sit at one offset from a 16-byte boundary, N * sizeof(T) is a
// multiple of 16, r_blk is aligned and agg is aligned at the first group
// (always in the solve), each thread takes groups of W = 16 / sizeof(T)
// vertices: z and r at rows v and v + N in 16-byte vectors, R_v in one
// 16-byte vector a vertex (two in f64), agg as int4 (int2 in f64), all
// loaded before the arithmetic; slice 0 also takes the elements before the
// first boundary and slice S - 1 those after the last group. Otherwise the
// slices cut the vertices and go one at a time. yc is read through the
// read-only cache (staging the frame's yc in shared memory first was slower
// on the card: 15.4 against 11.5 us in f32, 25.8 against 22.1 in f64, at
// the 12.5k shapes). Each vertex's z is the first design's expression
// (prolong_vertex); the block's r.z closes in slice order (common.cuh
// close_slices).
template <typename T>
__device__ __forceinline__ void prolong_vertex(T& z1, T& z2, T r1, T r2,
                                               const T* rv, T ya, T yb, T& acc) {
  z1 = z1 + (rv[0] * ya + rv[1] * yb);
  z2 = z2 + (rv[2] * ya + rv[3] * yb);
  acc += r1 * z1 + r2 * z2;
}

// One group of W aggregate ids from agg + v (16 bytes in f32, 8 in f64).
__device__ __forceinline__ void load_ids(const int* p, int (&ids)[4]) {
  const int4 q = __ldg(reinterpret_cast<const int4*>(p));
  ids[0] = q.x;
  ids[1] = q.y;
  ids[2] = q.z;
  ids[3] = q.w;
}
__device__ __forceinline__ void load_ids(const int* p, int (&ids)[2]) {
  const int2 q = __ldg(reinterpret_cast<const int2*>(p));
  ids[0] = q.x;
  ids[1] = q.y;
}

// K11 on vertices [lo, hi) of one frame, one element at a time.
template <typename T>
__device__ __forceinline__ void prolong_scalar(T* zt, const T* rt, const T* ys,
                                               const T* r_blk, const int* agg,
                                               int64_t n_vert, int64_t lo,
                                               int64_t hi, T& acc) {
  for (int64_t v = lo + threadIdx.x; v < hi; v += kThreads) {
    const int64_t w = v + n_vert;
    const int64_t i = agg[v];
    T z1 = zt[v], z2 = zt[w];
    prolong_vertex(z1, z2, rt[v], rt[w], r_blk + 4 * v, __ldg(ys + 2 * i),
                   __ldg(ys + 2 * i + 1), acc);
    zt[v] = z1;
    zt[w] = z2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    prolong_dot_kernel(T* __restrict__ z, const T* __restrict__ r,
                       const T* __restrict__ yc, const T* __restrict__ r_blk,
                       const int* __restrict__ agg, T* __restrict__ rz,
                       T* __restrict__ part, unsigned int* __restrict__ ticket,
                       int64_t n_frames, int64_t n_vert, int64_t n_coarse) {
  using V = typename Vec16<T>::type;
  constexpr int W = kVecWidth<T>;
  __shared__ T scratch[kWarps];
  const int n_slices = static_cast<int>(gridDim.x);
  const int s = static_cast<int>(blockIdx.x);
  for (int64_t t = blockIdx.y; t < n_frames; t += gridDim.y) {
    const int64_t off = t * 2 * n_vert;
    T* zt = z + off;
    const T* rt = r + off;
    const T* ys = yc + t * 2 * n_coarse;
    T acc = T(0);
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(zt) & 15;
    const int64_t head = head_to_16(zt, n_vert);
    const bool vec = (reinterpret_cast<uintptr_t>(rt) & 15) == a0 &&
                     (reinterpret_cast<uintptr_t>(r_blk) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(agg + head) & (4 * W - 1)) == 0 &&
                     ((n_vert * static_cast<int64_t>(sizeof(T))) & 15) == 0;
    if (vec) {
      const int64_t n_vec = (n_vert - head) / W;
      const int64_t per = (n_vec + n_slices - 1) / n_slices;
      const int64_t g_hi = (s + 1) * per < n_vec ? (s + 1) * per : n_vec;
      for (int64_t k = s * per + threadIdx.x; k < g_hi; k += kThreads) {
        const int64_t v = head + k * W;
        const int64_t w = v + n_vert;
        V zv[2], rv[2], bv[4];
        int ids[W];
        zv[0] = *reinterpret_cast<const V*>(zt + v);
        zv[1] = *reinterpret_cast<const V*>(zt + w);
        rv[0] = __ldg(reinterpret_cast<const V*>(rt + v));
        rv[1] = __ldg(reinterpret_cast<const V*>(rt + w));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          bv[q] = __ldg(reinterpret_cast<const V*>(r_blk + v * 4) + q);
        }
        load_ids(agg + v, ids);
        T z1[W], z2[W], r1[W], r2[W], b[4 * W];
        unpack(zv[0], z1);
        unpack(zv[1], z2);
        unpack(rv[0], r1);
        unpack(rv[1], r2);
#pragma unroll
        for (int q = 0; q < 4; ++q) unpack(bv[q], b + q * W);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const int64_t i = ids[j];
          prolong_vertex(z1[j], z2[j], r1[j], r2[j], b + 4 * j, __ldg(ys + 2 * i),
                         __ldg(ys + 2 * i + 1), acc);
        }
        *reinterpret_cast<V*>(zt + v) = pack(z1);
        *reinterpret_cast<V*>(zt + w) = pack(z2);
      }
      if (s == 0) prolong_scalar(zt, rt, ys, r_blk, agg, n_vert, int64_t(0), head, acc);
      if (s == n_slices - 1) {
        prolong_scalar(zt, rt, ys, r_blk, agg, n_vert, head + n_vec * W, n_vert, acc);
      }
    } else {
      const int64_t per = (n_vert + n_slices - 1) / n_slices;
      const int64_t hi = (s + 1) * per < n_vert ? (s + 1) * per : n_vert;
      prolong_scalar(zt, rt, ys, r_blk, agg, n_vert, s * per, hi, acc);
    }
    const T sums[1] = {block_sum(acc, scratch)};
    T* const outs[1] = {rz};
    close_slices(sums, outs, part, ticket, t);
  }
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
  constexpr int F = kRestrictFrames<T>;
  const int64_t groups = (n_frames + F - 1) / F;
  if (groups > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  if (n_frames > 0 && n_coarse > 0) {
    const dim3 grid(blocks_for(n_coarse * 32), static_cast<unsigned int>(groups));
    restrict_kernel<T, F><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(r), static_cast<const T*>(r_blk),
        static_cast<const int*>(members), static_cast<T*>(rc), n_frames, n_vert,
        n_coarse, k_width);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int coarse_gemv(const void* a, const void* x, void* y, int64_t n_frames,
                int64_t n, int64_t a_stride, void* stream) {
  const int64_t n_rows = n_frames * n;
  if (n_rows > 0) {
    const unsigned int blocks = blocks_for(n_rows * 32);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if constexpr (sizeof(T) == 4) {
      if (a_stride != 0) {
        gemv_vectors_kernel<<<blocks, kThreads, 0, s>>>(
            static_cast<const float*>(a), static_cast<const float*>(x),
            static_cast<float*>(y), n, a_stride, n_rows);
        return static_cast<int>(cudaGetLastError());
      }
    }
    gemv_kernel<T><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(x),
        static_cast<T*>(y), n, a_stride, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int coarse_prolong_dot(void* z, const void* r, const void* yc, const void* r_blk,
                       const void* agg, void* rz, void* part, void* ticket,
                       int64_t n_frames, int64_t n_vert, int64_t n_coarse,
                       int64_t n_slices, void* stream) {
  if (n_frames > 0) {
    if (n_slices < 1 || n_slices > kMaxSlices) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid(static_cast<unsigned int>(n_slices), frame_blocks(n_frames));
    prolong_dot_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<T*>(z), static_cast<const T*>(r), static_cast<const T*>(yc),
        static_cast<const T*>(r_blk), static_cast<const int*>(agg),
        static_cast<T*>(rz), static_cast<T*>(part),
        static_cast<unsigned int*>(ticket), n_frames, n_vert, n_coarse);
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
      const void* agg, void* rz, void* part, void* ticket, int64_t n_frames,   \
      int64_t n_vert, int64_t n_coarse, int64_t n_slices, void* stream) {      \
    return mf::coarse_prolong_dot<T>(z, r, yc, r_blk, agg, rz, part, ticket,   \
                                     n_frames, n_vert, n_coarse, n_slices,     \
                                     stream);                                  \
  }

MF_COARSE_ENTRY_POINTS(f32, float)
MF_COARSE_ENTRY_POINTS(f64, double)
