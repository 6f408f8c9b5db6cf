// Analysis kernels of the S3 flow stage: recombination and speed map (K5),
// singularity detection with per-frame counts (K6), and stable compaction
// with the nearest-vertex snap (K7). Layouts follow the JAX package:
//   v_k             (T, 2N)     velocity DOFs, dof = vertex + N * alpha
//   basis           (N, 2, 3)   tangent bases e
//   v_world         (T, N, 3)   world vectors
//   speed           (T, N)      |v_world|
//   v_max           (T,)        per-frame max of speed
//   masks           bool (one byte, 0 or 1)
//
// Every threshold decision (the vertex test, the 2x2 solve, the inside test,
// the nearest vertex) is computed with explicitly rounded operations in the
// JAX expression order: nvcc would otherwise contract a*b+c into fused
// multiply-adds, move results by an ulp and flip a mask against the plain
// torch version, which evaluates each operation separately.
// The C entry points return the cudaError_t of the launches.
#include "common.cuh"

namespace mf {

__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rn_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double rn_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rn_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float rn_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double rn_div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float rn_sqrt(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double rn_sqrt(double a) { return __dsqrt_rn(a); }

// (a0 b0 + a1 b1) + a2 b2, each operation rounded on its own.
template <typename T>
__device__ __forceinline__ T dot3(const T* a, const T* b) {
  return rn_add(rn_add(rn_mul(a[0], b[0]), rn_mul(a[1], b[1])), rn_mul(a[2], b[2]));
}

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

// Frames run over gridDim.y with a stride, so any frame count launches.
inline unsigned int frame_blocks(int64_t n_frames) {
  return static_cast<unsigned int>(n_frames < 65535 ? n_frames : 65535);
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

// K6, vertex half: vertex_mask = (speed / v_max) <= eps (divide, then
// compare, as ops/singularity.py:74 does), and the frame's count of singular
// vertices into counts[t, 0] (integer atomics: exact in any order).
template <typename T>
__global__ void detect_vertex_kernel(const T* __restrict__ speed,
                                     const T* __restrict__ v_max, T eps,
                                     uint8_t* __restrict__ vertex_mask,
                                     int32_t* __restrict__ counts,
                                     int64_t n_frames, int64_t n_vert) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t t = blockIdx.y; t < n_frames; t += gridDim.y) {
    bool hit = false;
    if (v < n_vert) {
      hit = rn_div(speed[t * n_vert + v], v_max[t]) <= eps;
      vertex_mask[t * n_vert + v] = hit;
    }
    const int n_hit = __syncthreads_count(hit);
    if (threadIdx.x == 0 && n_hit > 0) atomicAdd(counts + 2 * t, n_hit);
  }
}

// K6, triangle half (ops/singularity.py:80-111): one thread per (frame,
// triangle) projects the three normalised corner velocities onto the
// triangle's plane, solves the 2x2 normal equations of
// [VA-VC, VB-VC] [lam, mu]^T = -VC, and accepts solvable & inside &
// ~touches_singular, re-deriving the corners' vertex test from speed and
// v_max so no second pass is needed. A frame with v_max = 0 gives 0/0 = NaN
// everywhere: every comparison is false and nothing is detected, as in JAX.
template <typename T>
__global__ void detect_triangle_kernel(
    const T* __restrict__ points, const int32_t* __restrict__ tris,
    const T* __restrict__ v_world, const T* __restrict__ speed,
    const T* __restrict__ v_max, T eps, uint8_t* __restrict__ interior_mask,
    T* __restrict__ bary, T* __restrict__ point, int32_t* __restrict__ counts,
    int64_t n_frames, int64_t n_vert, int64_t n_tri) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool active = m < n_tri;
  int32_t idx[3] = {0, 0, 0};
  T p[3][3], nrm[3];
  if (active) {
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
  for (int64_t t = blockIdx.y; t < n_frames; t += gridDim.y) {
    bool hit = false;
    if (active) {
      const T vmax = v_max[t];
      T vp[3][3];
      bool touches = false;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int64_t o = t * n_vert + idx[c];
        touches = touches || (rn_div(speed[o], vmax) <= eps);
        T vn[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) vn[d] = rn_div(v_world[o * 3 + d], vmax);
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
      const T lam = rn_div(rn_sub(rn_mul(b1, a22), rn_mul(b2, a12)), safe);
      const T mu = rn_div(rn_sub(rn_mul(a11, b2), rn_mul(a12, b1)), safe);
      const bool inside = lam >= T(0) && mu >= T(0) && rn_add(lam, mu) <= T(1);
      hit = solvable && inside && !touches;
      const int64_t i = t * n_tri + m;
      interior_mask[i] = hit;
      bary[i * 2] = lam;
      bary[i * 2 + 1] = mu;
      const T w3 = rn_sub(rn_sub(T(1), lam), mu);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        point[i * 3 + d] = rn_add(rn_add(rn_mul(lam, p[0][d]), rn_mul(mu, p[1][d])),
                                  rn_mul(w3, p[2][d]));
      }
    }
    const int n_hit = __syncthreads_count(hit);
    if (threadIdx.x == 0 && n_hit > 0) atomicAdd(counts + 2 * t + 1, n_hit);
  }
}

// The first `cap` ids of a stable argsort of ~mask[0..n) into ids/valid:
// the masked ids ascending, then the lowest unmasked ids ascending
// (ops/singularity.py:413-418). Block-wide: a first pass counts the masked
// entries; the second ranks each entry by warp ballot plus the per-warp
// totals in shared memory. cap <= n, so every slot is written.
__device__ void compact_row(const uint8_t* __restrict__ mask, int64_t n,
                           int64_t cap, int32_t* __restrict__ ids,
                           uint8_t* __restrict__ valid, int* warp_masked,
                           int* warp_unmasked) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned int lower = (1u << lane) - 1u;
  int64_t n_masked = 0;
  for (int64_t base = 0; base < n; base += kThreads) {
    const int64_t i = base + threadIdx.x;
    n_masked += __syncthreads_count(i < n && mask[i] != 0);
  }
  int64_t seen_masked = 0, seen_unmasked = 0;
  for (int64_t base = 0; base < n; base += kThreads) {
    const int64_t i = base + threadIdx.x;
    const bool in = i < n;
    const bool f = in && mask[i] != 0;
    const unsigned int bal_m = __ballot_sync(0xffffffffu, f);
    const unsigned int bal_u = __ballot_sync(0xffffffffu, in && !f);
    if (lane == 0) {
      warp_masked[warp] = __popc(bal_m);
      warp_unmasked[warp] = __popc(bal_u);
    }
    __syncthreads();
    int64_t off_m = 0, off_u = 0, tot_m = 0, tot_u = 0;
    for (int k = 0; k < kWarps; ++k) {
      if (k < warp) {
        off_m += warp_masked[k];
        off_u += warp_unmasked[k];
      }
      tot_m += warp_masked[k];
      tot_u += warp_unmasked[k];
    }
    __syncthreads();  // the counts are rewritten in the next round
    if (f) {
      const int64_t slot = seen_masked + off_m + __popc(bal_m & lower);
      if (slot < cap) {
        ids[slot] = static_cast<int32_t>(i);
        valid[slot] = 1;
      }
    } else if (in) {
      const int64_t slot = n_masked + seen_unmasked + off_u + __popc(bal_u & lower);
      if (slot < cap) {
        ids[slot] = static_cast<int32_t>(i);
        valid[slot] = 0;
      }
    }
    seen_masked += tot_m;
    seen_unmasked += tot_u;
  }
}

// (a, ia) before (b, ib) in torch.argmin's order: NaN first, then the
// smaller value, ties to the lower index; an index < 0 is "no candidate".
template <typename T>
__device__ __forceinline__ bool argmin_before(T a, int ia, T b, int ib) {
  if (ia < 0) return false;
  if (ib < 0) return true;
  const bool a_nan = a != a, b_nan = b != b;
  if (a_nan) return !b_nan || ia < ib;
  if (b_nan) return false;
  return a == b ? ia < ib : a < b;
}

// K7: one block per frame compacts both masks to their slots, gathers the
// interior points of the interior slots, and snaps each of those points to
// its nearest vertex (geometry/topology.py:26): one warp per slot scans the
// N vertices for the (d^2, index) minimum, d^2 = sum((q - p)^2).
template <typename T>
__global__ void compact_detected_kernel(
    const uint8_t* __restrict__ vertex_mask,
    const uint8_t* __restrict__ interior_mask,
    const T* __restrict__ interior_point, const T* __restrict__ points,
    int32_t* __restrict__ vertex_ids, uint8_t* __restrict__ vertex_valid,
    int32_t* __restrict__ interior_ids, uint8_t* __restrict__ interior_valid,
    T* __restrict__ interior_points, int32_t* __restrict__ interior_centers,
    int64_t n_vert, int64_t n_tri, int64_t cap_v, int64_t cap_i) {
  __shared__ int warp_masked[kWarps];
  __shared__ int warp_unmasked[kWarps];
  const int64_t t = blockIdx.x;
  compact_row(vertex_mask + t * n_vert, n_vert, cap_v, vertex_ids + t * cap_v,
              vertex_valid + t * cap_v, warp_masked, warp_unmasked);
  int32_t* ids = interior_ids + t * cap_i;
  compact_row(interior_mask + t * n_tri, n_tri, cap_i, ids,
              interior_valid + t * cap_i, warp_masked, warp_unmasked);
  __syncthreads();
  T* pts = interior_points + t * cap_i * 3;
  for (int64_t s = threadIdx.x; s < cap_i; s += blockDim.x) {
    const int64_t src = (t * n_tri + ids[s]) * 3;
#pragma unroll
    for (int d = 0; d < 3; ++d) pts[s * 3 + d] = interior_point[src + d];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int64_t s = warp; s < cap_i; s += kWarps) {
    T q[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) q[d] = pts[s * 3 + d];
    T best = T(0);
    int best_i = -1;
    for (int64_t v = lane; v < n_vert; v += 32) {
      T diff[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) diff[d] = rn_sub(q[d], points[v * 3 + d]);
      const T d2 = dot3(diff, diff);
      if (argmin_before(d2, static_cast<int>(v), best, best_i)) {
        best = d2;
        best_i = static_cast<int>(v);
      }
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      const T other = __shfl_down_sync(0xffffffffu, best, offset);
      const int other_i = __shfl_down_sync(0xffffffffu, best_i, offset);
      if (argmin_before(other, other_i, best, best_i)) {
        best = other;
        best_i = other_i;
      }
    }
    if (lane == 0) interior_centers[t * cap_i + s] = best_i;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_frames > 0) {
    cudaMemsetAsync(counts, 0, n_frames * 2 * sizeof(int32_t), s);
  }
  if (n_frames > 0 && n_vert > 0) {
    const dim3 grid(blocks_for(n_vert), frame_blocks(n_frames));
    detect_vertex_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(speed), static_cast<const T*>(v_max),
        static_cast<T>(eps), static_cast<uint8_t*>(vertex_mask),
        static_cast<int32_t*>(counts), n_frames, n_vert);
  }
  if (n_frames > 0 && n_tri > 0) {
    const dim3 grid(blocks_for(n_tri), frame_blocks(n_frames));
    detect_triangle_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(points), static_cast<const int32_t*>(tris),
        static_cast<const T*>(v_world), static_cast<const T*>(speed),
        static_cast<const T*>(v_max), static_cast<T>(eps),
        static_cast<uint8_t*>(interior_mask), static_cast<T*>(bary),
        static_cast<T*>(point), static_cast<int32_t*>(counts), n_frames,
        n_vert, n_tri);
  }
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
  if (n_frames > 0) {
    compact_detected_kernel<T><<<static_cast<unsigned int>(n_frames), kThreads,
                                 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(vertex_mask),
        static_cast<const uint8_t*>(interior_mask),
        static_cast<const T*>(interior_point), static_cast<const T*>(points),
        static_cast<int32_t*>(vertex_ids), static_cast<uint8_t*>(vertex_valid),
        static_cast<int32_t*>(interior_ids),
        static_cast<uint8_t*>(interior_valid), static_cast<T*>(interior_points),
        static_cast<int32_t*>(interior_centers), n_vert, n_tri, cap_v, cap_i);
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
  }

MF_ANALYSIS_ENTRY_POINTS(f32, float)
MF_ANALYSIS_ENTRY_POINTS(f64, double)
