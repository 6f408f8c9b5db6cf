// Analysis kernels of the S3 flow stage: recombination and speed map (K5),
// singularity detection with per-frame counts (K6), stable compaction with
// the nearest-vertex snap (K7), and the classification of the compacted
// candidates (K12). Layouts follow the JAX package:
//   v_k             (T, 2N)     velocity DOFs, dof = vertex + N * alpha
//   basis           (N, 2, 3)   tangent bases e
//   v_world         (T, N, 3)   world vectors
//   speed           (T, N)      |v_world|
//   v_max           (T,)        per-frame max of speed
//   masks           bool (one byte, 0 or 1)
//
// Every threshold decision (the vertex test, the 2x2 solve, the inside test,
// the nearest vertex, the nearest edge, the class code) is computed with the
// explicitly rounded operations of common.cuh, in the JAX expression order.
// The C entry points return the cudaError_t of the launches.
#include "common.cuh"

namespace mf {

// Max that keeps a NaN, as torch.amax and jnp.max do.
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a != a || a > b) ? a : b;  // a != a: a is NaN
}

// Max of v over a block of kThreads threads, valid in thread 0.
template <typename T>
__device__ __forceinline__ T block_max(T v, T* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = max_nan(v, __shfl_down_sync(0xffffffffu, v, offset));
  }
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T total = v;
  if (warp == 0) {
    total = lane < kWarps ? scratch[lane] : scratch[0];
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      total = max_nan(total, __shfl_down_sync(0xffffffffu, total, offset));
    }
  }
  __syncthreads();
  return total;
}

// atomicMax on the bit pattern: for non-negative floats (speeds are
// sqrt(...) >= +0) the unsigned order of the bits is the order of the
// values, and a NaN's bits exceed every number's, so it propagates.
__device__ __forceinline__ void atomic_max_nonneg(float* addr, float v) {
  atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}
__device__ __forceinline__ void atomic_max_nonneg(double* addr, double v) {
  atomicMax(reinterpret_cast<unsigned long long*>(addr),
            static_cast<unsigned long long>(__double_as_longlong(v)));
}

// K5: one thread per (frame, vertex) forms v = c1 e1 + c2 e2 and
// |v| = sqrt(x^2 + y^2 + z^2) (ops/recombine.py:20, :36); the block's max
// speed goes to v_max[t] by atomicMax (order-free, so runs repeat exactly).
template <typename T>
__global__ void recombine_speed_kernel(const T* __restrict__ v_k,
                                       const T* __restrict__ basis,
                                       T* __restrict__ v_world,
                                       T* __restrict__ speed,
                                       T* __restrict__ v_max, int64_t n_frames,
                                       int64_t n_vert) {
  __shared__ T scratch[kWarps];
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t t = blockIdx.y; t < n_frames; t += gridDim.y) {
    T s = T(0);
    if (v < n_vert) {
      const T c1 = v_k[t * 2 * n_vert + v];
      const T c2 = v_k[t * 2 * n_vert + n_vert + v];
      const T* e = basis + v * 6;
      T w[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) w[d] = rn_add(rn_mul(c1, e[d]), rn_mul(c2, e[3 + d]));
      T* o = v_world + (t * n_vert + v) * 3;
#pragma unroll
      for (int d = 0; d < 3; ++d) o[d] = w[d];
      s = rn_sqrt(dot3(w, w));
      speed[t * n_vert + v] = s;
    }
    s = block_max(s, scratch);
    if (threadIdx.x == 0) atomic_max_nonneg(v_max + t, s);
  }
}

// ------------------------------------------------------------------ K6
// Singularity detection with per-frame counts (ops/singularity.py:54
// detect, :356 detection_counts, :371 detect_with_counts; B8): the vertex
// test vertex_mask = (speed / v_max) <= eps (divide, then compare, as
// ops/singularity.py:74 does) and the triangle-interior zeros of
// ops/singularity.py:80-111: the three normalised corner velocities are
// projected onto the triangle's plane, the 2x2 normal equations of
// [VA-VC, VB-VC] [lam, mu]^T = -VC solved, and a triangle accepted when
// solvable & inside & ~touches_singular, its corners' vertex test
// re-derived from speed and v_max so no second pass is needed. A frame with
// v_max = 0 gives 0/0 = NaN everywhere: every comparison is false and
// nothing is detected, as in JAX. A degenerate triangle (|n| = 0) keeps its
// zero normal, as the plain version's division by 1 does.
//
// Bound on this card: memory traffic, most of it writes. At 12.5k vertices
// x 97 frames in f64 a call writes 99 MB (the interior points 57 MB, the
// barycentric pairs 38 MB, the masks 3.6 MB) and reads 39 MB (v_world and
// the speeds): 41 us at 3.35 TB/s. Beside the bytes run 34.8 M correctly
// rounded f64 divisions (14 a frame and triangle, one a frame and vertex),
// each a chain of dependent operations with a call to a slow path.
//
// Design: one launch of kDetectThreads-thread blocks. The first tri_blocks
// along x take runs of consecutive triangles, the rest runs of vertices;
// along y the frames go in groups of kDetectFrames consecutive frames. A
// triangle thread loads its corner ids and corners and forms the unit
// normal (a square root, three divisions) once for all its frames; each
// frame then gathers the 12 corner values (all loaded before the first
// division), divides them by v_max, solves, and stores the mask byte, the
// (lam, mu) pair as one vector store and the point's three values. Each
// thread keeps its hits as bits; after the group, each warp's popcount of a
// frame's bits goes to a shared counter and one thread per frame adds the
// block's count to counts[t] with an integer atomic (exact in any order).
// The registers are capped for kDetectMinBlocks blocks an SM. Every output
// element keeps the first design's explicitly rounded operations in their
// order, so the outputs are bit for bit those of one thread a
// (frame, element). What holds it back on an H100: the divisions' chains
// (at 12.5k vertices, about 18 of its 75 us go when they become
// products), then the corner gathers (12) and the stores (7). A quotient
// through a reciprocal shared by the frame is as exact where no operand
// nears the ends of the exponent range, but checking that costs as much
// as it saves.
constexpr int kDetectThreads = 128;
constexpr int kDetectFrames = 4;
constexpr int kDetectMinBlocks = 6;

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

// A frame's v_max and the speeds and world vectors of a triangle's corners.
template <typename T>
struct FrameCorners {
  T vmax, sp[3], vw[3][3];
};

template <typename T>
__device__ __forceinline__ FrameCorners<T> load_corners(const T* __restrict__ v_world,
                                                        const T* __restrict__ speed,
                                                        const T* __restrict__ v_max,
                                                        const int32_t (&idx)[3], int64_t t,
                                                        int64_t n_vert) {
  FrameCorners<T> fc;
  fc.vmax = v_max[t];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int64_t o = t * n_vert + idx[c];
    fc.sp[c] = speed[o];
#pragma unroll
    for (int d = 0; d < 3; ++d) fc.vw[c][d] = v_world[o * 3 + d];
  }
  return fc;
}

// One (frame, triangle)'s outputs.
template <typename T>
struct TriangleHit {
  T lam, mu, pt[3];
  bool hit;
};

// The interior test of one (frame, triangle) (ops/singularity.py:80-111),
// every operation rounded on its own in the first design's order.
template <typename T>
__device__ __forceinline__ TriangleHit<T> triangle_hit(const FrameCorners<T>& fc,
                                                       const T (&nrm)[3], const T (&p)[3][3],
                                                       T eps) {
  T vp[3][3];
  bool touches = false;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    touches = touches || (rn_div(fc.sp[c], fc.vmax) <= eps);
    T vn[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) vn[d] = rn_div(fc.vw[c][d], fc.vmax);
    const T s = dot3(vn, nrm);
#pragma unroll
    for (int d = 0; d < 3; ++d) vp[c][d] = rn_sub(vn[d], rn_mul(s, nrm[d]));
  }
  T c1[3], c2[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    c1[d] = rn_sub(vp[0][d], vp[2][d]);
    c2[d] = rn_sub(vp[1][d], vp[2][d]);
  }
  const T a11 = dot3(c1, c1);
  const T a12 = dot3(c1, c2);
  const T a22 = dot3(c2, c2);
  const T b1 = -dot3(c1, vp[2]);
  const T b2 = -dot3(c2, vp[2]);
  const T det = rn_sub(rn_mul(a11, a22), rn_mul(a12, a12));
  const bool solvable = det > T(0) || det < T(0);  // |det| > 0
  const T safe = solvable ? det : T(1);
  TriangleHit<T> out;
  out.lam = rn_div(rn_sub(rn_mul(b1, a22), rn_mul(b2, a12)), safe);
  out.mu = rn_div(rn_sub(rn_mul(a11, b2), rn_mul(a12, b1)), safe);
  const bool inside = out.lam >= T(0) && out.mu >= T(0) && rn_add(out.lam, out.mu) <= T(1);
  out.hit = solvable && inside && !touches;
  const T w3 = rn_sub(rn_sub(T(1), out.lam), out.mu);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    out.pt[d] = rn_add(rn_add(rn_mul(out.lam, p[0][d]), rn_mul(out.mu, p[1][d])),
                       rn_mul(w3, p[2][d]));
  }
  return out;
}

// A triangle's corner ids, corners and unit normal (ops/singularity.py:
// 84-88), the same for every frame.
template <typename T>
__device__ __forceinline__ void triangle_geometry(const T* __restrict__ points,
                                                  const int32_t* __restrict__ tris,
                                                  int64_t m, int32_t (&idx)[3],
                                                  T (&p)[3][3], T (&nrm)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    idx[c] = tris[m * 3 + c];
#pragma unroll
    for (int d = 0; d < 3; ++d) p[c][d] = points[static_cast<int64_t>(idx[c]) * 3 + d];
  }
  T u[3], w[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    u[d] = rn_sub(p[1][d], p[0][d]);
    w[d] = rn_sub(p[2][d], p[0][d]);
  }
  nrm[0] = rn_sub(rn_mul(u[1], w[2]), rn_mul(u[2], w[1]));
  nrm[1] = rn_sub(rn_mul(u[2], w[0]), rn_mul(u[0], w[2]));
  nrm[2] = rn_sub(rn_mul(u[0], w[1]), rn_mul(u[1], w[0]));
  const T nn = rn_sqrt(dot3(nrm, nrm));
  const T den = nn > T(0) ? nn : T(1);
#pragma unroll
  for (int d = 0; d < 3; ++d) nrm[d] = rn_div(nrm[d], den);
}

// Adds the block's hits of frames t0 .. t0 + F - 1 (bit f of each thread's
// `hits`) to counts[2 t + which]: each warp's popcount into a shared
// counter, then one integer atomic a frame. Every thread of the block calls
// it; it leaves the counters at 0 for the next group.
template <int F>
__device__ __forceinline__ void add_frame_hits(unsigned int hits, int* block_hits,
                                               int32_t* __restrict__ counts, int64_t t0,
                                               int64_t n_frames, int which) {
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int c = __popc(__ballot_sync(0xffffffffu, (hits >> f) & 1u));
    if ((threadIdx.x & 31) == 0 && c > 0) atomicAdd(block_hits + f, c);
  }
  __syncthreads();
  if (threadIdx.x < F) {
    const int c = block_hits[threadIdx.x];
    if (c > 0 && t0 + threadIdx.x < n_frames) {
      atomicAdd(counts + 2 * (t0 + threadIdx.x) + which, c);
    }
    block_hits[threadIdx.x] = 0;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kDetectThreads, kDetectMinBlocks) detect_singular_kernel(
    const T* __restrict__ points, const int32_t* __restrict__ tris,
    const T* __restrict__ v_world, const T* __restrict__ speed,
    const T* __restrict__ v_max, T eps, uint8_t* __restrict__ vertex_mask,
    uint8_t* __restrict__ interior_mask, T* __restrict__ bary, T* __restrict__ point,
    int32_t* __restrict__ counts, int64_t n_frames, int64_t n_vert, int64_t n_tri,
    int64_t tri_blocks) {
  constexpr int F = kDetectFrames;
  __shared__ int block_hits[F];
  if (threadIdx.x < F) block_hits[threadIdx.x] = 0;
  __syncthreads();
  const int64_t n_groups = (n_frames + F - 1) / F;
  if (static_cast<int64_t>(blockIdx.x) >= tri_blocks) {
    // The vertex test.
    const int64_t v =
        (static_cast<int64_t>(blockIdx.x) - tri_blocks) * kDetectThreads + threadIdx.x;
    for (int64_t g = blockIdx.y; g < n_groups; g += gridDim.y) {
      const int64_t t0 = g * F;
      unsigned int hits = 0u;
      if (v < n_vert) {
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const int64_t t = t0 + f;
          if (t < n_frames) {
            const bool hit = rn_div(speed[t * n_vert + v], v_max[t]) <= eps;
            vertex_mask[t * n_vert + v] = hit;
            hits |= static_cast<unsigned int>(hit) << f;
          }
        }
      }
      add_frame_hits<F>(hits, block_hits, counts, t0, n_frames, 0);
    }
    return;
  }
  // The triangle test: the corners and unit normal once for all frames.
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kDetectThreads + threadIdx.x;
  const bool active = m < n_tri;
  int32_t idx[3] = {0, 0, 0};
  T p[3][3], nrm[3];
  if (active) triangle_geometry(points, tris, m, idx, p, nrm);
  for (int64_t g = blockIdx.y; g < n_groups; g += gridDim.y) {
    const int64_t t0 = g * F;
    unsigned int hits = 0u;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int64_t t = t0 + f;
      if (t >= n_frames) break;  // the same for the whole block
      if (active) {
        const TriangleHit<T> out =
            triangle_hit(load_corners(v_world, speed, v_max, idx, t, n_vert), nrm, p, eps);
        const int64_t i = t * n_tri + m;
        interior_mask[i] = out.hit;
        typename Pair<T>::type pair;
        pair.x = out.lam;
        pair.y = out.mu;
        reinterpret_cast<typename Pair<T>::type*>(bary)[i] = pair;
#pragma unroll
        for (int d = 0; d < 3; ++d) point[i * 3 + d] = out.pt[d];
        hits |= static_cast<unsigned int>(out.hit) << f;
      }
    }
    add_frame_hits<F>(hits, block_hits, counts, t0, n_frames, 1);
  }
}

// ------------------------------------------------------------------ K7
// Compaction of both detection masks and the nearest-vertex snap of the
// interior slots (ops/singularity.py:394 compact_detected with
// geometry/topology.py:26 closest_vertex, B8), two launches behind one
// entry point. Bound on this card: the snap's float64 arithmetic. A call
// computes T S N distances d^2 = (dx^2 + dy^2) + dz^2, 8 operations each,
// every one rounded on its own in the plain version's order (no fused
// multiply-add, or the centers would move), and compares each with the
// running minimum: at 12.5k vertices (T = 97 frames, S = 16 slots) 19.5 M
// distances. Issued one by one, those operations run at half the 34
// TFLOP/s that counts a fused multiply-add as two: about 9.2 us of
// arithmetic, against 4.58 us from the bound's formula. The masks (3.6 MB
// at 12.5k) are read once.
// The first design ran one block of 256 threads a frame (97 blocks on 132
// SMs): its compaction ranked 256 mask bytes a round with two barriers and
// a serial loop over the warps' totals, and one warp a slot then scanned
// all N vertices in strided 8-byte loads from device memory.
// This design:
//  * compaction, a block per (mask, frame): each thread takes a contiguous
//    run of the row and counts its set bytes from 16-byte loads; one
//    block-wide scan of those counts gives each thread the first masked and
//    unmasked slots of its run; only threads with a slot under the capacity
//    go over their run again, placing a 16-byte group's ids from its bit
//    mask of set bytes; then one thread a slot copies the interior slots'
//    points;
//  * snap, a block per (frame, group of kSnapSlots slots): its threads take
//    the vertices in turn, each loading its next vertex while the current
//    one's distances run, and keep the minimum (d^2, index) of each slot in
//    registers; the block merges them with warp shuffles, then across warps
//    in shared memory, in argmin_before's order, a total order, so any
//    merge tree gives torch.argmin's answer (ties to the lower index, a NaN
//    first). Swept on the H100 at both mesh sizes: 4 slots a block beat 2
//    and 8, loading 1 vertex ahead beat 2 and 4, and staging tiles of the
//    vertices in shared memory was slower.

constexpr int kSnapSlots = 4;  // slots a snap block serves (G)

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// Exclusive prefix sum of v over the block's kThreads threads; the block's
// total goes to *total. scratch: kWarps ints of shared memory, free again on
// return.
__device__ __forceinline__ int block_exclusive_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? scratch[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) scratch[lane] = w;
  }
  __syncthreads();
  const int before = (warp > 0 ? scratch[warp - 1] : 0) + x - v;
  *total = scratch[kWarps - 1];
  __syncthreads();
  return before;
}

// Bit b set for each non-zero byte b of the 16 of w.
__device__ __forceinline__ unsigned int set_bits(uint4 w) {
  unsigned int bits = 0;
  const unsigned int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned int b = __vsetne4(words[k], 0u);  // 1 in each non-zero byte
    bits |= ((b & 1u) | (b >> 7 & 2u) | (b >> 14 & 4u) | (b >> 21 & 8u)) << (4 * k);
  }
  return bits;
}

// The first `cap` ids of a stable argsort of ~mask[0..n) into ids/valid:
// the masked ids ascending, then the lowest unmasked ids ascending
// (ops/singularity.py:413-418), also where more than `cap` ids are masked.
// Where `src` is given, slot k's point (src[3 id .. 3 id + 3)) goes to
// pts[3 k ..]. Every thread of the block calls it.
template <typename T>
__device__ void compact_row(const uint8_t* __restrict__ mask, int64_t n, int64_t cap,
                            int32_t* __restrict__ ids, uint8_t* __restrict__ valid,
                            const T* __restrict__ src, T* __restrict__ pts, int* scratch) {
  // Thread i's run [lo, hi) of the row: whole 16-byte groups from the first
  // 16-byte boundary; thread 0 also takes the bytes before it, the last
  // thread those after the last whole group.
  const int64_t head = head_to_16(mask, n);
  const int64_t n_vec = (n - head) / 16;
  const int64_t per = (n_vec + kThreads - 1) / kThreads;
  const int64_t i = threadIdx.x;
  const int64_t k0 = min64(i * per, n_vec), k1 = min64(k0 + per, n_vec);
  const int64_t lo = i == 0 ? 0 : head + 16 * k0;
  const int64_t hi = i == kThreads - 1 ? n : head + 16 * k1;
  const uint4* vec = reinterpret_cast<const uint4*>(mask + head);
  int c = 0;
  for (int64_t j = lo; j < head + 16 * k0; ++j) c += mask[j] != 0;
#pragma unroll 4
  for (int64_t k = k0; k < k1; ++k) c += __popc(set_bits(__ldg(vec + k)));
  for (int64_t j = head + 16 * k1; j < hi; ++j) c += mask[j] != 0;
  int n_masked;
  const int before = block_exclusive_scan(c, scratch, &n_masked);
  int64_t slot_m = before;                    // the run's next masked slot
  int64_t slot_u = n_masked + (lo - before);  // and its next unmasked one
  const int64_t m_end = before + c < cap ? before + c : cap;
  // Only runs with a masked id, or an unmasked one, under the capacity write.
  auto room = [&] { return slot_m < m_end || slot_u < cap; };
  auto place = [&](int64_t j, bool f) {
    const int64_t slot = f ? slot_m++ : slot_u++;
    if (slot < cap) {
      ids[slot] = static_cast<int32_t>(j);
      valid[slot] = f;
    }
  };
  for (int64_t j = lo; j < head + 16 * k0 && room(); ++j) place(j, mask[j] != 0);
  for (int64_t k = k0; k < k1 && room(); ++k) {
    // The group's set bytes as 16 bits; its masked ids, then its unmasked
    // ones, go to their slots lowest first while slots are left.
    const unsigned int set = set_bits(__ldg(vec + k));
    const int64_t j0 = head + 16 * k;
    for (unsigned int m = set; m != 0 && slot_m < m_end; m &= m - 1) {
      ids[slot_m] = static_cast<int32_t>(j0 + __ffs(m) - 1);
      valid[slot_m++] = 1;
    }
    for (unsigned int m = ~set & 0xffffu; m != 0 && slot_u < cap; m &= m - 1) {
      ids[slot_u] = static_cast<int32_t>(j0 + __ffs(m) - 1);
      valid[slot_u++] = 0;
    }
  }
  for (int64_t j = head + 16 * k1; j < hi && room(); ++j) place(j, mask[j] != 0);
  if (src != nullptr) {  // each slot's point, one thread a slot
    __syncthreads();     // the ids are written
    for (int64_t k = threadIdx.x; k < cap; k += kThreads) {
      const int64_t j = ids[k];
#pragma unroll
      for (int d = 0; d < 3; ++d) pts[k * 3 + d] = src[j * 3 + d];
    }
  }
}

// K7, compaction: block (0, t) compacts frame t's vertex mask, block (1, t)
// its interior mask with the slots' points.
template <typename T>
__global__ void __launch_bounds__(kThreads) compact_detected_masks_kernel(
    const uint8_t* __restrict__ vertex_mask, const uint8_t* __restrict__ interior_mask,
    const T* __restrict__ interior_point, int32_t* __restrict__ vertex_ids,
    uint8_t* __restrict__ vertex_valid, int32_t* __restrict__ interior_ids,
    uint8_t* __restrict__ interior_valid, T* __restrict__ interior_points,
    int64_t n_frames, int64_t n_vert, int64_t n_tri, int64_t cap_v, int64_t cap_i) {
  __shared__ int scratch[kWarps];
  for (int64_t t = blockIdx.y; t < n_frames; t += gridDim.y) {
    if (blockIdx.x == 0) {
      compact_row<T>(vertex_mask + t * n_vert, n_vert, cap_v, vertex_ids + t * cap_v,
                     vertex_valid + t * cap_v, nullptr, nullptr, scratch);
    } else {
      compact_row<T>(interior_mask + t * n_tri, n_tri, cap_i, interior_ids + t * cap_i,
                     interior_valid + t * cap_i, interior_point + t * n_tri * 3,
                     interior_points + t * cap_i * 3, scratch);
    }
  }
}

// One vertex (px, py, pz) of index v against a thread's G queries: each
// slot keeps the first vertex, then any with a smaller d^2 or a NaN, until
// it holds a NaN (ties keep the lower index, the vertices coming in
// ascending order).
template <typename T, int G>
__device__ __forceinline__ void snap_update(const T (&q)[G][3], T (&best)[G],
                                            int (&best_i)[G], bool (&nan_held)[G],
                                            T px, T py, T pz, int v) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T dx = rn_sub(q[g][0], px), dy = rn_sub(q[g][1], py), dz = rn_sub(q[g][2], pz);
    const T d2 = rn_add(rn_add(rn_mul(dx, dx), rn_mul(dy, dy)), rn_mul(dz, dz));
    if (best_i[g] < 0 || (!nan_held[g] && !(d2 >= best[g]))) {
      best[g] = d2;
      best_i[g] = v;
      nan_held[g] = d2 != d2;
    }
  }
}

// K7, snap: block (g, t) finds, for the G slots g G .. g G + G - 1 of frame
// t, the nearest vertex. Its threads take the vertices in turn, loading the
// next one's point while the current one's distances run; each keeps its
// minimum per slot in registers, and the block merges them with warp
// shuffles, then across warps in shared memory, in argmin_before's order.
// queries: (T, cap, 3), the compacted points.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads) compact_detected_snap_kernel(
    const T* __restrict__ points, const T* __restrict__ queries,
    int32_t* __restrict__ centers, int64_t n_frames, int64_t n_vert, int64_t cap) {
  __shared__ T red_d2[kWarps][G];
  __shared__ int red_i[kWarps][G];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t slot0 = static_cast<int64_t>(blockIdx.x) * G;
  for (int64_t t = blockIdx.y; t < n_frames; t += gridDim.y) {
    T q[G][3];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int64_t s = slot0 + g;
#pragma unroll
      for (int d = 0; d < 3; ++d) q[g][d] = s < cap ? queries[(t * cap + s) * 3 + d] : T(0);
    }
    T best[G];
    int best_i[G];
    bool nan_held[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      best[g] = T(0);
      best_i[g] = -1;
      nan_held[g] = false;
    }
    // This thread's vertices threadIdx.x + k kThreads, ascending.
    int64_t v = threadIdx.x;
    T nx = T(0), ny = T(0), nz = T(0);
    if (v < n_vert) {
      nx = __ldg(points + 3 * v);
      ny = __ldg(points + 3 * v + 1);
      nz = __ldg(points + 3 * v + 2);
    }
    for (; v < n_vert; v += kThreads) {
      const T px = nx, py = ny, pz = nz;
      const int64_t w = v + kThreads;
      if (w < n_vert) {
        nx = __ldg(points + 3 * w);
        ny = __ldg(points + 3 * w + 1);
        nz = __ldg(points + 3 * w + 2);
      }
      snap_update(q, best, best_i, nan_held, px, py, pz, static_cast<int>(v));
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const T other = __shfl_down_sync(0xffffffffu, best[g], o);
        const int other_i = __shfl_down_sync(0xffffffffu, best_i[g], o);
        if (argmin_before(other, other_i, best[g], best_i[g])) {
          best[g] = other;
          best_i[g] = other_i;
        }
      }
      if (lane == 0) {
        red_d2[warp][g] = best[g];
        red_i[warp][g] = best_i[g];
      }
    }
    __syncthreads();
    if (threadIdx.x < G && slot0 + threadIdx.x < cap) {
      const int g = threadIdx.x;
      T b = red_d2[0][g];
      int bi = red_i[0][g];
      for (int w = 1; w < kWarps; ++w) {
        if (argmin_before(red_d2[w][g], red_i[w][g], b, bi)) {
          b = red_d2[w][g];
          bi = red_i[w][g];
        }
      }
      centers[t * cap + slot0 + g] = bi;
    }
    __syncthreads();  // red_* are rewritten for the next frame
  }
}

template <typename T>
int recombine_speed(const void* v_k, const void* basis, void* v_world,
                    void* speed, void* v_max, int64_t n_frames, int64_t n_vert,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_frames > 0) {
    cudaMemsetAsync(v_max, 0, n_frames * sizeof(T), s);  // +0.0
  }
  if (n_frames > 0 && n_vert > 0) {
    const dim3 grid(blocks_for(n_vert), frame_blocks(n_frames));
    recombine_speed_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(v_k), static_cast<const T*>(basis),
        static_cast<T*>(v_world), static_cast<T*>(speed), static_cast<T*>(v_max),
        n_frames, n_vert);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int detect_singular(const void* points, const void* tris, const void* v_world,
                    const void* speed, const void* v_max, double eps,
                    void* vertex_mask, void* interior_mask, void* bary,
                    void* point, void* counts, int64_t n_frames,
                    int64_t n_vert, int64_t n_tri, void* stream) {
  if (reinterpret_cast<uintptr_t>(bary) % sizeof(typename Pair<T>::type) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);  // the pair stores
  }
  if (n_frames <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(counts, 0, n_frames * 2 * sizeof(int32_t), s);
  if (n_vert + n_tri <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t tri_blocks = (n_tri + kDetectThreads - 1) / kDetectThreads;
  const int64_t vert_blocks = (n_vert + kDetectThreads - 1) / kDetectThreads;
  const int64_t groups = (n_frames + kDetectFrames - 1) / kDetectFrames;
  const dim3 grid(static_cast<unsigned int>(tri_blocks + vert_blocks),
                  static_cast<unsigned int>(groups < 65535 ? groups : 65535));
  detect_singular_kernel<T><<<grid, kDetectThreads, 0, s>>>(
      static_cast<const T*>(points), static_cast<const int32_t*>(tris),
      static_cast<const T*>(v_world), static_cast<const T*>(speed),
      static_cast<const T*>(v_max), static_cast<T>(eps),
      static_cast<uint8_t*>(vertex_mask), static_cast<uint8_t*>(interior_mask),
      static_cast<T*>(bary), static_cast<T*>(point), static_cast<int32_t*>(counts), n_frames,
      n_vert, n_tri, tri_blocks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int compact_detected(const void* vertex_mask, const void* interior_mask,
                     const void* interior_point, const void* points,
                     void* vertex_ids, void* vertex_valid, void* interior_ids,
                     void* interior_valid, void* interior_points,
                     void* interior_centers, int64_t n_frames, int64_t n_vert,
                     int64_t n_tri, int64_t cap_v, int64_t cap_i,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_frames <= 0) return static_cast<int>(cudaGetLastError());
  compact_detected_masks_kernel<T><<<dim3(2, frame_blocks(n_frames)), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(vertex_mask), static_cast<const uint8_t*>(interior_mask),
      static_cast<const T*>(interior_point), static_cast<int32_t*>(vertex_ids),
      static_cast<uint8_t*>(vertex_valid), static_cast<int32_t*>(interior_ids),
      static_cast<uint8_t*>(interior_valid), static_cast<T*>(interior_points), n_frames,
      n_vert, n_tri, cap_v, cap_i);
  if (cap_i > 0) {
    const dim3 grid(static_cast<unsigned int>((cap_i + kSnapSlots - 1) / kSnapSlots),
                    frame_blocks(n_frames));
    compact_detected_snap_kernel<T, kSnapSlots><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(points), static_cast<const T*>(interior_points),
        static_cast<int32_t*>(interior_centers), n_frames, n_vert, cap_i);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ K12
// Classification of the compacted candidates (ops/singularity.py:279
// classify_detected, B9): a finite-difference 2x2 Jacobian per candidate
// (:115 _jacobian_from_neighbors), then the trace/determinant code (:166).
// Bound on this card: latency. At the bench shapes (97 frames, S = 16
// slots of each kind) a call reads a few hundred kB, mostly 1-ring
// velocities from L2, but each neighbour's term is a chain of about nine
// correctly rounded f64 divisions, and an interior slot first forms its
// triangle's normal, a tangent basis and the nearest edge. The first
// design ran one thread per (frame, slot) in two launches (vertex slots,
// then interior slots), each thread adding its neighbours one after the
// other, with 16 of each 256-thread block's lanes at work. Here one launch
// runs vertex blocks, then interior blocks; a group of kClassifyLanes lanes
// takes a (frame, slot), one neighbour a lane (a wider 1-ring takes more
// rounds), and every lane of the group adds the lanes' terms to the
// Jacobian through shuffles in table order. An interior group forms the
// plane and the basis in every lane and measures one edge a lane (lane %
// 3), then takes the argmin in the first design's order from the lanes'
// values. Every operation is rounded on its own, in the plain version's
// order, and a masked neighbour adds +0 as before, so the codes and the
// Jacobians are the plain version's and the first design's bit for bit.

// The tangent plane (e1, e2) with n = e1 x e2 and n.n, as project_to_plane
// (geometry/tangent.py) forms them for every call.
template <typename T>
struct Plane {
  T e1[3], e2[3], n[3], nn;
};

template <typename T>
__device__ __forceinline__ void make_plane(const T* e1, const T* e2, Plane<T>& p) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    p.e1[d] = e1[d];
    p.e2[d] = e2[d];
  }
  cross3(p.e1, p.e2, p.n);
  p.nn = dot3(p.n, p.n);
}

// v - where(n.n > 0, (v.n) / n.n, 0) n.
template <typename T>
__device__ __forceinline__ void project_plane(const T* v, const Plane<T>& p, T* out) {
  const T s = p.nn > T(0) ? rn_div(dot3(v, p.n), p.nn) : T(0);
#pragma unroll
  for (int d = 0; d < 3; ++d) out[d] = rn_sub(v[d], rn_mul(s, p.n[d]));
}

// One neighbour's term [[u/d1, u/d2], [w/d1, w/d2]]: (u, w) its projected
// velocity on (e1, e2), (d1, d2) its projected offset from `origin`, a zero
// offset contributing 0; a masked neighbour's term is +0.
template <typename T>
__device__ __forceinline__ void jacobian_term(const T* origin, const T* nb_point,
                                              const T* nb_vel, bool mask,
                                              const Plane<T>& p, T* term) {
  T vp[3], diff[3], proj[3];
  project_plane(nb_vel, p, vp);
  const T u = rn_div(dot3(vp, p.e1), dot3(p.e1, p.e1));
  const T w = rn_div(dot3(vp, p.e2), dot3(p.e2, p.e2));
#pragma unroll
  for (int d = 0; d < 3; ++d) diff[d] = rn_sub(nb_point[d], origin[d]);
  project_plane(diff, p, proj);
  const T d1 = dot3(proj, p.e1);
  const T d2 = dot3(proj, p.e2);
  const T i1 = d1 != T(0) ? rn_div(T(1), d1) : T(0);
  const T i2 = d2 != T(0) ? rn_div(T(1), d2) : T(0);
  term[0] = mask ? rn_mul(u, i1) : T(0);
  term[1] = mask ? rn_mul(u, i2) : T(0);
  term[2] = mask ? rn_mul(w, i1) : T(0);
  term[3] = mask ? rn_mul(w, i2) : T(0);
}

constexpr int kClassifyLanes = 8;     // lanes a (frame, slot)
constexpr int kClassifyThreads = 128;  // 16 slots a block; 32-256 ran alike

// The group's terms of lanes 0..n-1 added to jac in lane order, the same
// sums in every lane of the group (`group`: its lanes' bits in the warp).
template <typename T>
__device__ __forceinline__ void add_terms(const T* term, int n, unsigned int group,
                                          T* jac) {
  for (int k = 0; k < n; ++k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      jac[q] = rn_add(jac[q], __shfl_sync(group, term[q], k, kClassifyLanes));
    }
  }
}

// NODE 0, FOCUS 1, SADDLE 2, INDETERMINATE 3 (ops/singularity.py:166).
template <typename T>
__device__ __forceinline__ int32_t classify_code(const T* j) {
  const T tr = rn_add(j[0], j[3]);
  const T det = rn_sub(rn_mul(j[0], j[3]), rn_mul(j[1], j[2]));
  if (det > T(0)) return rn_mul(tr, tr) > rn_mul(T(4), det) ? 0 : 1;
  return det < T(0) ? 2 : 3;
}

template <typename T>
__device__ __forceinline__ void normalize3(T* v) {
  const T nrm = rn_sqrt(dot3(v, v));
#pragma unroll
  for (int d = 0; d < 3; ++d) v[d] = nrm > T(0) ? rn_div(v[d], nrm) : T(0);
}

// The tangent basis of a unit normal (geometry/tangent.py tangent_basis).
template <typename T>
__device__ __forceinline__ void tangent_basis(const T* n, T* e1, T* e2) {
  if (n[0] != T(0) || n[1] != T(0)) {
    e1[0] = -n[1];
    e1[1] = n[0];
    e1[2] = T(0);
  } else {
    e1[0] = T(0);
    e1[1] = -n[2];
    e1[2] = n[1];
  }
  normalize3(e1);
  cross3(n, e1, e2);
  normalize3(e2);
}

// |c| / max(|b - a|, 1e-300), c = (q - a) x (b - a): the distance of q from
// the line through a and b; the three components of c / max(|b - a|, 1e-300)
// in quirk mode.
template <typename T>
__device__ __forceinline__ void edge_cross(const T* q, const T* a, const T* b, T* c,
                                           T& den) {
  T qa[3], ab[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    qa[d] = rn_sub(q[d], a[d]);
    ab[d] = rn_sub(b[d], a[d]);
  }
  cross3(qa, ab, c);
  den = max_nan(rn_sqrt(dot3(ab, ab)), T(1e-300));
}

// The edge (0: AB, 1: BC, 2: CA) whose neighbour triangle joins the
// interior point's set (ops/singularity.py:133 _nearest_edge): the argmin of
// the three distances, or in quirk mode the argmin over all nine
// |component| values mapped {0: AB, 1: BC, else: CA}. Lane e (mod 3) of the
// group measures edge e; every lane then takes the argmin over the values
// of lanes 0-2 in the order (edge, component).
template <typename T>
__device__ __forceinline__ int nearest_edge(const T* q, T (*p)[3], bool quirks, int lane,
                                            unsigned int group) {
  const int e = lane % 3;
  T a[3], b[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    a[d] = e == 0 ? p[0][d] : (e == 1 ? p[1][d] : p[2][d]);
    b[d] = e == 0 ? p[1][d] : (e == 1 ? p[2][d] : p[0][d]);
  }
  T c[3], den, v[3] = {T(0), T(0), T(0)};
  edge_cross(q, a, b, c, den);
  if (quirks) {
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = fabs(rn_div(c[k], den));
  } else {
    v[0] = rn_div(rn_sqrt(dot3(c, c)), den);
  }
  T best = T(0);
  int best_i = -1;
  const int per_edge = quirks ? 3 : 1;
#pragma unroll
  for (int src = 0; src < 3; ++src) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k < per_edge) {
        const T x = __shfl_sync(group, v[k], src, kClassifyLanes);
        const int i = per_edge * src + k;
        if (argmin_before(x, i, best, best_i)) {
          best = x;
          best_i = i;
        }
      }
    }
  }
  if (quirks) return best_i == 0 ? 0 : (best_i == 1 ? 1 : 2);
  return best_i;
}

template <typename T>
__device__ __forceinline__ void store_class(const T* jac, int64_t slot,
                                            int32_t* __restrict__ codes,
                                            T* __restrict__ jac_out) {
  store4(jac_out + slot * 4, jac);
  codes[slot] = classify_code(jac);
}

// Vertex slot `item` (frame * cap + slot): the 1-ring of the vertex, on the
// vertex's basis, neighbour d in lane d % kClassifyLanes.
template <typename T>
__device__ __forceinline__ void classify_vertex_slot(
    int64_t item, int lane, unsigned int group, const T* __restrict__ points,
    const T* __restrict__ basis, const int32_t* __restrict__ neighbors,
    const T* __restrict__ v_world, const T* __restrict__ v_max,
    const int32_t* __restrict__ ids, const uint8_t* __restrict__ valid,
    int32_t* __restrict__ codes, T* __restrict__ jac_out, int64_t n_vert,
    int64_t width, int64_t cap) {
  const int64_t t = item / cap;
  const int64_t id = ids[item];
  const bool ok = valid[item] != 0;
  Plane<T> p;
  make_plane(basis + id * 6, basis + id * 6 + 3, p);
  const T vmax = v_max[t];
  T jac[4] = {T(0), T(0), T(0), T(0)};
  for (int64_t d0 = 0; d0 < width; d0 += kClassifyLanes) {
    const int64_t d = d0 + lane;
    T term[4] = {T(0), T(0), T(0), T(0)};
    if (d < width) {
      const int32_t nb = neighbors[id * width + d];
      const bool mask = ok && nb != -1;
      const int64_t src = mask ? nb : 0;
      T vel[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) vel[k] = rn_div(v_world[(t * n_vert + src) * 3 + k], vmax);
      jacobian_term(points + id * 3, points + src * 3, vel, mask, p, term);
    }
    const int64_t left = width - d0;
    add_terms(term, left < kClassifyLanes ? static_cast<int>(left) : kClassifyLanes,
              group, jac);
  }
  if (lane == 0) store_class(jac, item, codes, jac_out);
}

// Interior slot `item`: the triangle's corners (lanes 0-2) and those of the
// triangle across the nearest edge (lanes 3-5; itself on a boundary edge),
// each vertex once, on the basis of the flat triangle normal, about the
// interior point.
template <typename T>
__device__ __forceinline__ void classify_interior_slot(
    int64_t item, int lane, unsigned int group, const T* __restrict__ points,
    const int32_t* __restrict__ tris, const int32_t* __restrict__ across,
    const T* __restrict__ v_world, const T* __restrict__ v_max,
    const int32_t* __restrict__ ids, const uint8_t* __restrict__ valid,
    const T* __restrict__ interior_points, int32_t* __restrict__ codes,
    T* __restrict__ jac_out, int64_t n_vert, int64_t cap, bool quirks) {
  const int64_t t = item / cap;
  const int64_t id = ids[item];
  const bool ok = valid[item] != 0;
  T p[3][3], q[3];
  int32_t nb[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    nb[c] = tris[id * 3 + c];
#pragma unroll
    for (int d = 0; d < 3; ++d) p[c][d] = points[static_cast<int64_t>(nb[c]) * 3 + d];
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) q[d] = interior_points[item * 3 + d];
  T u[3], w[3], nrm[3], e1[3], e2[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    u[d] = rn_sub(p[1][d], p[0][d]);
    w[d] = rn_sub(p[2][d], p[0][d]);
  }
  cross3(u, w, nrm);
  const T nl = rn_sqrt(dot3(nrm, nrm));
  const T den = nl > T(0) ? nl : T(1);
#pragma unroll
  for (int d = 0; d < 3; ++d) nrm[d] = rn_div(nrm[d], den);
  tangent_basis(nrm, e1, e2);
  const int edge = nearest_edge(q, p, quirks, lane, group);
  int64_t other = across[id * 3 + edge];
  if (other < 0) other = id;
#pragma unroll
  for (int c = 0; c < 3; ++c) nb[3 + c] = tris[other * 3 + c];
  Plane<T> pl;
  make_plane(e1, e2, pl);
  const T vmax = v_max[t];
  T term[4] = {T(0), T(0), T(0), T(0)};
  if (lane < 6) {
    int32_t mine = nb[0];
#pragma unroll
    for (int j = 1; j < 6; ++j) mine = lane == j ? nb[j] : mine;
    bool first = true;
#pragma unroll
    for (int j = 0; j < 5; ++j) first = first && !(j < lane && nb[j] == mine);
    const int64_t src = mine;
    T vel[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) vel[k] = rn_div(v_world[(t * n_vert + src) * 3 + k], vmax);
    jacobian_term(q, points + src * 3, vel, first && ok, pl, term);
  }
  T jac[4] = {T(0), T(0), T(0), T(0)};
  add_terms(term, 6, group, jac);
  if (lane == 0) store_class(jac, item, codes, jac_out);
}

// One launch: the first vertex_blocks blocks take the vertex slots, the
// rest the interior slots, kClassifyThreads / kClassifyLanes slots a block.
template <typename T>
__global__ void __launch_bounds__(kClassifyThreads) classify_candidates_kernel(
    const T* __restrict__ points, const T* __restrict__ basis,
    const int32_t* __restrict__ neighbors, const int32_t* __restrict__ tris,
    const int32_t* __restrict__ across, const T* __restrict__ v_world,
    const T* __restrict__ v_max, const int32_t* __restrict__ vertex_ids,
    const uint8_t* __restrict__ vertex_valid, const int32_t* __restrict__ interior_ids,
    const uint8_t* __restrict__ interior_valid, const T* __restrict__ interior_points,
    int32_t* __restrict__ vertex_codes, T* __restrict__ vertex_jac,
    int32_t* __restrict__ interior_codes, T* __restrict__ interior_jac,
    int64_t n_frames, int64_t n_vert, int64_t width, int64_t cap_v, int64_t cap_i,
    bool quirks, int64_t vertex_blocks) {
  constexpr int kGroups = kClassifyThreads / kClassifyLanes;
  const int lane = threadIdx.x % kClassifyLanes;
  const unsigned int group = 0xffu << (threadIdx.x & 24);
  const int64_t slot = threadIdx.x / kClassifyLanes;
  const int64_t b = blockIdx.x;
  if (b < vertex_blocks) {
    const int64_t item = b * kGroups + slot;
    if (item >= n_frames * cap_v) return;  // the group's lanes leave together
    classify_vertex_slot(item, lane, group, points, basis, neighbors, v_world, v_max,
                         vertex_ids, vertex_valid, vertex_codes, vertex_jac, n_vert,
                         width, cap_v);
  } else {
    const int64_t item = (b - vertex_blocks) * kGroups + slot;
    if (item >= n_frames * cap_i) return;
    classify_interior_slot(item, lane, group, points, tris, across, v_world, v_max,
                           interior_ids, interior_valid, interior_points,
                           interior_codes, interior_jac, n_vert, cap_i, quirks);
  }
}

template <typename T>
int classify_candidates(const void* points, const void* basis, const void* neighbors,
                        const void* tris, const void* across, const void* v_world,
                        const void* v_max, const void* vertex_ids,
                        const void* vertex_valid, const void* interior_ids,
                        const void* interior_valid, const void* interior_points,
                        void* vertex_codes, void* vertex_jac, void* interior_codes,
                        void* interior_jac, int64_t n_frames, int64_t n_vert,
                        int64_t width, int64_t cap_v, int64_t cap_i, int64_t quirks,
                        void* stream) {
  constexpr int kGroups = kClassifyThreads / kClassifyLanes;
  const int64_t vertex_blocks =
      n_frames > 0 ? (n_frames * cap_v + kGroups - 1) / kGroups : 0;
  const int64_t interior_blocks =
      n_frames > 0 ? (n_frames * cap_i + kGroups - 1) / kGroups : 0;
  if (vertex_blocks + interior_blocks > 0) {
    classify_candidates_kernel<T><<<static_cast<unsigned int>(vertex_blocks + interior_blocks),
                                    kClassifyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(points), static_cast<const T*>(basis),
        static_cast<const int32_t*>(neighbors), static_cast<const int32_t*>(tris),
        static_cast<const int32_t*>(across), static_cast<const T*>(v_world),
        static_cast<const T*>(v_max), static_cast<const int32_t*>(vertex_ids),
        static_cast<const uint8_t*>(vertex_valid), static_cast<const int32_t*>(interior_ids),
        static_cast<const uint8_t*>(interior_valid), static_cast<const T*>(interior_points),
        static_cast<int32_t*>(vertex_codes), static_cast<T*>(vertex_jac),
        static_cast<int32_t*>(interior_codes), static_cast<T*>(interior_jac), n_frames,
        n_vert, width, cap_v, cap_i, quirks != 0, vertex_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mf

#define MF_ANALYSIS_ENTRY_POINTS(SUFFIX, T)                                     \
  extern "C" int mf_recombine_speed_##SUFFIX(                                   \
      const void* v_k, const void* basis, void* v_world, void* speed,           \
      void* v_max, int64_t n_frames, int64_t n_vert, void* stream) {            \
    return mf::recombine_speed<T>(v_k, basis, v_world, speed, v_max, n_frames,  \
                                  n_vert, stream);                              \
  }                                                                             \
  extern "C" int mf_detect_singular_##SUFFIX(                                   \
      const void* points, const void* tris, const void* v_world,                \
      const void* speed, const void* v_max, double eps, void* vertex_mask,      \
      void* interior_mask, void* bary, void* point, void* counts,               \
      int64_t n_frames, int64_t n_vert, int64_t n_tri, void* stream) {          \
    return mf::detect_singular<T>(points, tris, v_world, speed, v_max, eps,     \
                                  vertex_mask, interior_mask, bary, point,      \
                                  counts, n_frames, n_vert, n_tri, stream);     \
  }                                                                             \
  extern "C" int mf_compact_detected_##SUFFIX(                                  \
      const void* vertex_mask, const void* interior_mask,                       \
      const void* interior_point, const void* points, void* vertex_ids,         \
      void* vertex_valid, void* interior_ids, void* interior_valid,             \
      void* interior_points, void* interior_centers, int64_t n_frames,          \
      int64_t n_vert, int64_t n_tri, int64_t cap_v, int64_t cap_i,              \
      void* stream) {                                                           \
    return mf::compact_detected<T>(vertex_mask, interior_mask, interior_point,  \
                                   points, vertex_ids, vertex_valid,            \
                                   interior_ids, interior_valid,                \
                                   interior_points, interior_centers,           \
                                   n_frames, n_vert, n_tri, cap_v, cap_i,       \
                                   stream);                                     \
  }                                                                             \
  extern "C" int mf_classify_candidates_##SUFFIX(                              \
      const void* points, const void* basis, const void* neighbors,             \
      const void* tris, const void* across, const void* v_world,                \
      const void* v_max, const void* vertex_ids, const void* vertex_valid,      \
      const void* interior_ids, const void* interior_valid,                     \
      const void* interior_points, void* vertex_codes, void* vertex_jac,        \
      void* interior_codes, void* interior_jac, int64_t n_frames,               \
      int64_t n_vert, int64_t width, int64_t cap_v, int64_t cap_i,              \
      int64_t quirks, void* stream) {                                           \
    return mf::classify_candidates<T>(                                          \
        points, basis, neighbors, tris, across, v_world, v_max, vertex_ids,     \
        vertex_valid, interior_ids, interior_valid, interior_points,            \
        vertex_codes, vertex_jac, interior_codes, interior_jac, n_frames,       \
        n_vert, width, cap_v, cap_i, quirks, stream);                           \
  }

MF_ANALYSIS_ENTRY_POINTS(f32, float)
MF_ANALYSIS_ENTRY_POINTS(f64, double)
