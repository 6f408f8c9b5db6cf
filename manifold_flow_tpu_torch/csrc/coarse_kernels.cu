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
//       its gathers bound it: every contribution (887k, ~176 an entry) of
//       every frame reads two g pairs, scattered over the triangles. The
//       design keeps the (T, M, 36) contributions (344 MB) out of memory
//       and forms each one in registers. Its first design ran a warp per
//       (frame, entry): the frame-independent half of each contribution
//       (the CSR list, the corners, R_v, the area) came again for each of
//       the 97 frames, one dependent chain in flight a lane (522 us on the
//       card). This design gives a warp a pair of sibling entries (y = 0
//       and 1, which list the same contributions) for a group of frames, in
//       blocks of two warps: that half loads once a group and each g pair
//       once for both entries, then the group's g pairs go out together
//       (211 us). See assemble_kernel.
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

// K8 works on pairs of sibling entries. The CSR (solve/coarse.py
// assembly_csr) lists the entry (row, 2b) at an even index e and its sibling
// (row, 2b + 1) at e + 1; e's contributions s are all even (y = 0) and e + 1
// lists s + 1 for each, in the same order (the same triangle and corners,
// y = 1). assembly_csr checks this on the host. So a warp serves pair p,
// entries 2p and 2p + 1, from e's list alone.
//
// Pairs differ in length (a diagonal entry lists several times the
// contributions of the others), and a block holds its SM's slots until its
// longest warp ends: small blocks waste fewer. Phases 1 and 2 run 64
// threads a block, 'mean' 32 (ptxas then gives its frame loop more
// registers). On the card at the 12.5k shapes, 32, 64, 128 and 256
// threads: f32 phases 1 + 2 at F = 4 took 213.6-213.8, 210.8-211.1,
// 220.5-221.2 and 304.0-304.1 us, f64 at F = 2 330.2-330.6, 313.3-313.6,
// 324.3-327.5 and 446.1-447.2; 'mean' f32 510.6-513.5, 1001.7-1002.3,
// 995.2-996.6 and 1004.7-1005.2.
constexpr int kAssembleThreads = 64;
constexpr int kMeanThreads = 32;

// The frame-independent part of contribution s (y = 0) and of its sibling
// s + 1: the triangle m, the corners c and c2, R_c's column x (R_c[0][x],
// R_c[1][x]), the whole block R_c2 (R_c2[b][y] at rd[2b + y]) and the weight
// w = (1 + delta_cc2) A / 12.
template <typename T>
struct Fixed {
  int64_t m;
  int c, c2;
  T rc0, rc2, rd[4], w;
};

template <typename T>
__device__ __forceinline__ Fixed<T> load_fixed(int s, const T* __restrict__ r_blk,
                                               bool r_aligned,
                                               const int* __restrict__ triangles,
                                               const T* __restrict__ w_scale) {
  const Contribution q = decode(s);
  const int64_t vc = __ldg(triangles + 3 * q.m + q.c);
  const int64_t vd = __ldg(triangles + 3 * q.m + q.c2);
  Fixed<T> p;
  p.m = q.m;
  p.c = q.c;
  p.c2 = q.c2;
  p.rc0 = __ldg(r_blk + 4 * vc + q.x);
  p.rc2 = __ldg(r_blk + 4 * vc + 2 + q.x);
  load_block(r_blk + 4 * vd, r_aligned, p.rd);
  p.w = (q.c == q.c2 ? T(2) : T(1)) * __ldg(w_scale + q.m);
  return p;
}

// K8, phase 1: the frame-independent a2 part of every non-zero coarse entry,
// a2c[e] = sum over the entry's contributions of
// sum_{a,b} R_c[a][x] B2[(c,a),(c2,b)] R_c2[b][y] (solve/coarse.py:299-304);
// one warp per pair of entries, its lanes striding through the first
// entry's CSR list, each lane summing both entries' terms.
template <typename T>
__global__ void __launch_bounds__(kAssembleThreads)
    coarse_a2_kernel(const T* __restrict__ blocks2, const T* __restrict__ r_blk,
                     const int* __restrict__ triangles, const T* __restrict__ w_scale,
                     const int* __restrict__ ptr, const int* __restrict__ src,
                     T* __restrict__ a2c, int64_t n_pairs) {
  const int64_t e = 2 * (global_index() >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= 2 * n_pairs) return;  // uniform across the warp
  const bool r_aligned = (reinterpret_cast<uintptr_t>(r_blk) & 15) == 0;
  T acc0 = T(0), acc1 = T(0);
  const int k1 = __ldg(ptr + e + 1);
  for (int k = __ldg(ptr + e) + lane; k < k1; k += 32) {
    const Fixed<T> q = load_fixed(__ldg(src + k), r_blk, r_aligned, triangles, w_scale);
    const T* b = blocks2 + 36 * q.m + (2 * q.c) * 6 + 2 * q.c2;
    const T rc[2] = {q.rc0, q.rc2};
    T v0 = T(0), v1 = T(0);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const T ab = __ldg(b + a * 6 + bb);
        v0 += rc[a] * ab * q.rd[2 * bb];
        v1 += rc[a] * ab * q.rd[2 * bb + 1];
      }
    }
    acc0 += v0;
    acc1 += v1;
  }
  acc0 = warp_sum(acc0);
  acc1 = warp_sum(acc1);
  if (lane == 0) {
    a2c[e] = acc0;
    a2c[e + 1] = acc1;
  }
}

// The g pair type: 8 bytes in f32, 16 in f64.
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// g_c^0 and g_c^1 of one (frame, triangle, corner): adjacent values, one
// load where `aligned`.
template <typename T>
__device__ __forceinline__ void load_pair(const T* p, bool aligned, T& a, T& b) {
  if (aligned) {
    const typename Pair<T>::type q = __ldg(reinterpret_cast<const typename Pair<T>::type*>(p));
    a = q.x;
    b = q.y;
  } else {
    a = __ldg(p);
    b = __ldg(p + 1);
  }
}

// K8, phase 2: out[t][dst[e]] = a1c[t][e] + lambda * a2c[e], with a1c[t][e]
// the sum over the entry's contributions of w_cc2 (Rg)_c^x (Rg)_c2^y,
// w = (A/12)(1 + delta_cc2) (solve/coarse.py:318-330), where (Rg)_c^x =
// g_c^0 R_c[0][x] + g_c^1 R_c[1][x] is the a1 factor of corner c on its
// aggregate's coarse basis. One warp per (pair of entries, group of F
// frames): lane l takes the first entry's contributions l, l + 32, ...,
// loads the frame-independent part of each once for the group (Fixed),
// then the g pairs g_c and g_c2 of every frame of the group (one 8-byte
// load each in f32, one 16-byte load in f64, where g is aligned) before the
// multiply-adds, which serve both entries (y = 0 and 1). Each entry's lane
// sum adds its contributions in CSR order, in the expression of a warp per
// (frame, entry), the first design, then the fixed-order warp sum closes
// it: the matrices are bitwise that design's. F = 16 / sizeof(T): 4 was the
// fastest of 1, 2, 4, 8 in f32 (358-364, 263-265, 245-248, 490-494 us at
// the 12.5k shapes on the card, with 256 threads a block and lone entries
// allowed) and 2 in f64 (473-494, 404-410, 435-443, 807-821); at 64
// threads a block f32 took 243.4-243.7 us at F = 2 against 210.8-211.1 at
// 4, f64 313.3-313.6 at 2 against 326.0-332.1 at 4.
template <typename T>
constexpr int kAssembleFrames = 16 / static_cast<int>(sizeof(T));

// lambda * a2c[e] + each frame's sum, into the entry's slot of every frame
// of the group.
template <typename T, int F>
__device__ __forceinline__ void write_entry(T* __restrict__ out, const T (&acc)[F],
                                            T a2, T lambda, int64_t d, int64_t t0,
                                            int64_t n_frames, int64_t nc2sq) {
#pragma unroll
  for (int f = 0; f < F; ++f) {
    if (t0 + f < n_frames) out[(t0 + f) * nc2sq + d] = acc[f] + lambda * a2;
  }
}

template <typename T, int F>
__global__ void __launch_bounds__(kAssembleThreads)
    assemble_kernel(const T* __restrict__ g, const T* __restrict__ r_blk,
                    const int* __restrict__ triangles,
                    const T* __restrict__ w_scale, const int* __restrict__ ptr,
                    const int* __restrict__ src, const int* __restrict__ dst,
                    const T* __restrict__ a2c, T lambda, T* __restrict__ out,
                    int64_t n_frames, int64_t m_tri, int64_t n_pairs, int64_t nc2sq) {
  const int64_t e = 2 * (global_index() >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= 2 * n_pairs) return;  // uniform across the warp
  const int64_t t0 = static_cast<int64_t>(blockIdx.y) * F;
  const bool aligned = (reinterpret_cast<uintptr_t>(g) & (2 * sizeof(T) - 1)) == 0;
  const bool r_aligned = (reinterpret_cast<uintptr_t>(r_blk) & 15) == 0;
  T acc0[F], acc1[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc0[f] = acc1[f] = T(0);
  const int k1 = __ldg(ptr + e + 1);
  for (int k = __ldg(ptr + e) + lane; k < k1; k += 32) {
    const Fixed<T> q = load_fixed(__ldg(src + k), r_blk, r_aligned, triangles, w_scale);
    T ga[F], gb[F], gc[F], gd[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      ga[f] = gb[f] = gc[f] = gd[f] = T(0);
      if (t0 + f < n_frames) {
        const T* gm = g + ((t0 + f) * m_tri + q.m) * 6;
        load_pair(gm + 2 * q.c, aligned, ga[f], gb[f]);
        load_pair(gm + 2 * q.c2, aligned, gc[f], gd[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const T cf = ga[f] * q.rc0 + gb[f] * q.rc2;
      T s0 = T(0), s1 = T(0);
      s0 += cf * (gc[f] * q.rd[0] + gd[f] * q.rd[2]);
      s1 += cf * (gc[f] * q.rd[1] + gd[f] * q.rd[3]);
      acc0[f] += s0 * q.w;
      acc1[f] += s1 * q.w;
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    acc0[f] = warp_sum(acc0[f]);
    acc1[f] = warp_sum(acc1[f]);
  }
  if (lane != 0) return;
  write_entry<T, F>(out, acc0, a2c[e], lambda, __ldg(dst + e), t0, n_frames, nc2sq);
  write_entry<T, F>(out, acc1, a2c[e + 1], lambda, __ldg(dst + e + 1), t0, n_frames,
                    nc2sq);
}

// K8's phase 2 in 'mean' mode (one shared matrix): one warp per pair of
// entries; each lane sums every frame of its contribution in frame order for
// both entries, the frame-independent part loaded once (Fixed) and each g
// pair in one load, and the warp's sums are divided by the frame count.
template <typename T>
__global__ void __launch_bounds__(kMeanThreads)
    assemble_mean_kernel(const T* __restrict__ g, const T* __restrict__ r_blk,
                         const int* __restrict__ triangles,
                         const T* __restrict__ w_scale, const int* __restrict__ ptr,
                         const int* __restrict__ src, const int* __restrict__ dst,
                         const T* __restrict__ a2c, T lambda, T* __restrict__ out,
                         int64_t n_frames, int64_t m_tri, int64_t n_pairs) {
  const int64_t e = 2 * (global_index() >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= 2 * n_pairs) return;  // uniform across the warp
  const bool aligned = (reinterpret_cast<uintptr_t>(g) & (2 * sizeof(T) - 1)) == 0;
  const bool r_aligned = (reinterpret_cast<uintptr_t>(r_blk) & 15) == 0;
  T acc0 = T(0), acc1 = T(0);
  const int k1 = __ldg(ptr + e + 1);
  for (int k = __ldg(ptr + e) + lane; k < k1; k += 32) {
    const Fixed<T> q = load_fixed(__ldg(src + k), r_blk, r_aligned, triangles, w_scale);
    T s0 = T(0), s1 = T(0);
    for (int64_t f = 0; f < n_frames; ++f) {
      const T* gm = g + (f * m_tri + q.m) * 6;
      T ga, gb, gc, gd;
      load_pair(gm + 2 * q.c, aligned, ga, gb);
      load_pair(gm + 2 * q.c2, aligned, gc, gd);
      const T cf = ga * q.rc0 + gb * q.rc2;
      s0 += cf * (gc * q.rd[0] + gd * q.rd[2]);
      s1 += cf * (gc * q.rd[1] + gd * q.rd[3]);
    }
    acc0 += s0 * q.w;
    acc1 += s1 * q.w;
  }
  acc0 = warp_sum(acc0);
  acc1 = warp_sum(acc1);
  if (lane != 0) return;
  acc0 /= static_cast<T>(n_frames);
  acc1 /= static_cast<T>(n_frames);
  out[__ldg(dst + e)] = acc0 + lambda * a2c[e];
  out[__ldg(dst + e + 1)] = acc1 + lambda * a2c[e + 1];
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
// close_slices). r.z is summed in the accumulator type A: A = T, or double
// for float vectors in the precise instance (f32acc64, solve_cg's
// precise_dots), whose partials stay double until the frame's sum is
// written; z is the same in both.
template <typename T, typename A>
__device__ __forceinline__ void prolong_vertex(T& z1, T& z2, T r1, T r2,
                                               const T* rv, T ya, T yb, A& acc) {
  z1 = z1 + (rv[0] * ya + rv[1] * yb);
  z2 = z2 + (rv[2] * ya + rv[3] * yb);
  acc += static_cast<A>(r1) * static_cast<A>(z1) + static_cast<A>(r2) * static_cast<A>(z2);
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
template <typename T, typename A>
__device__ __forceinline__ void prolong_scalar(T* zt, const T* rt, const T* ys,
                                               const T* r_blk, const int* agg,
                                               int64_t n_vert, int64_t lo,
                                               int64_t hi, A& acc) {
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

template <typename T, typename A>
__global__ void __launch_bounds__(kThreads)
    prolong_dot_kernel(T* __restrict__ z, const T* __restrict__ r,
                       const T* __restrict__ yc, const T* __restrict__ r_blk,
                       const int* __restrict__ agg, T* __restrict__ rz,
                       A* __restrict__ part, unsigned int* __restrict__ ticket,
                       int64_t n_frames, int64_t n_vert, int64_t n_coarse) {
  using V = typename Vec16<T>::type;
  constexpr int W = kVecWidth<T>;
  __shared__ A scratch[kWarps];
  const int n_slices = static_cast<int>(gridDim.x);
  const int s = static_cast<int>(blockIdx.x);
  for (int64_t t = blockIdx.y; t < n_frames; t += gridDim.y) {
    const int64_t off = t * 2 * n_vert;
    T* zt = z + off;
    const T* rt = r + off;
    const T* ys = yc + t * 2 * n_coarse;
    A acc = A(0);
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
    const A sums[1] = {block_sum(acc, scratch)};
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
  constexpr int F = kAssembleFrames<T>;
  const int64_t groups = mean ? 1 : (n_frames + F - 1) / F;
  if (groups > kMaxGridY || nnz % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_pairs = nnz / 2;
  if (n_pairs > 0 && n_frames > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const T lam = static_cast<T>(lambda);
    const int64_t n_threads = n_pairs * 32;
    const auto blocks = [n_threads](int per) {
      return static_cast<unsigned int>((n_threads + per - 1) / per);
    };
    coarse_a2_kernel<T><<<blocks(kAssembleThreads), kAssembleThreads, 0, s>>>(
        static_cast<const T*>(blocks2), static_cast<const T*>(r_blk),
        static_cast<const int*>(triangles), static_cast<const T*>(w_scale),
        static_cast<const int*>(ptr), static_cast<const int*>(src),
        static_cast<T*>(a2c), n_pairs);
    if (mean) {
      assemble_mean_kernel<T><<<blocks(kMeanThreads), kMeanThreads, 0, s>>>(
          static_cast<const T*>(g), static_cast<const T*>(r_blk),
          static_cast<const int*>(triangles), static_cast<const T*>(w_scale),
          static_cast<const int*>(ptr), static_cast<const int*>(src),
          static_cast<const int*>(dst), static_cast<const T*>(a2c), lam,
          static_cast<T*>(out), n_frames, m_tri, n_pairs);
    } else {
      const dim3 grid(blocks(kAssembleThreads), static_cast<unsigned int>(groups));
      assemble_kernel<T, F><<<grid, kAssembleThreads, 0, s>>>(
          static_cast<const T*>(g), static_cast<const T*>(r_blk),
          static_cast<const int*>(triangles), static_cast<const T*>(w_scale),
          static_cast<const int*>(ptr), static_cast<const int*>(src),
          static_cast<const int*>(dst), static_cast<const T*>(a2c), lam,
          static_cast<T*>(out), n_frames, m_tri, n_pairs, nc2 * nc2);
    }
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

template <typename T, typename A>
int coarse_prolong_dot(void* z, const void* r, const void* yc, const void* r_blk,
                       const void* agg, void* rz, void* part, void* ticket,
                       int64_t n_frames, int64_t n_vert, int64_t n_coarse,
                       int64_t n_slices, void* stream) {
  if (n_frames > 0) {
    if (n_slices < 1 || n_slices > kMaxSlices) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid(static_cast<unsigned int>(n_slices), frame_blocks(n_frames));
    prolong_dot_kernel<T, A><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<T*>(z), static_cast<const T*>(r), static_cast<const T*>(yc),
        static_cast<const T*>(r_blk), static_cast<const int*>(agg),
        static_cast<T*>(rz), static_cast<A*>(part),
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
  }

// K11 in three instances: float and double (A = T), and float with a double
// r.z (f32acc64, solve_cg's precise_dots).
#define MF_PROLONG_DOT_ENTRY_POINT(SUFFIX, T, A)                               \
  extern "C" int mf_coarse_prolong_dot_##SUFFIX(                               \
      void* z, const void* r, const void* yc, const void* r_blk,               \
      const void* agg, void* rz, void* part, void* ticket, int64_t n_frames,   \
      int64_t n_vert, int64_t n_coarse, int64_t n_slices, void* stream) {      \
    return mf::coarse_prolong_dot<T, A>(z, r, yc, r_blk, agg, rz, part,        \
                                        ticket, n_frames, n_vert, n_coarse,    \
                                        n_slices, stream);                     \
  }

MF_COARSE_ENTRY_POINTS(f32, float)
MF_COARSE_ENTRY_POINTS(f64, double)
MF_PROLONG_DOT_ENTRY_POINT(f32, float, float)
MF_PROLONG_DOT_ENTRY_POINT(f64, double, double)
MF_PROLONG_DOT_ENTRY_POINT(f32acc64, float, double)
