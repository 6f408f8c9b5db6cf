// Winding kernel of the S7 stage (K15): the ring winding numbers of every
// (unique center, frame), with the ring-persistence count and type.
// Layouts follow the JAX package (ops/winding.py _RingTables, one row per
// unique center, built in torch once per center):
//   v_world  (T, N, 3)   world velocity vectors
//   order    (U, R)      int32 ring members sorted by (ring level, polar
//                        angle), truncated at the last ring's end R
//   bounds   (U, L + 1)  int32 ring r occupies order[u, bounds[r]:bounds[r+1]]
//   e1, e2   (U, 3)      the center's tangent basis
// Outputs: counts and types (U, T) int32, winding numbers w (U, T, L).
// The C entry points return the cudaError_t of the launch.
#include "common.cuh"

namespace mf {

// Replaces ops/winding.py:127 _profile_from_tables with :173 _count_and_type
// over the :458 grid (B12). Per ring: each member's velocity projected onto
// the center's plane and expressed on (e1, e2), normalised; the signed
// angles (arccos of the clipped dot, the sign of the 2-D cross product)
// between consecutive members and the closing pair, summed, over 2 pi.
// Bound on this card: f64 arithmetic, not bytes. v_world is read once from
// device memory (7.3 MB in f64 at the bench shapes, about 2.5 us at 3.35
// TB/s) and the members' re-reads come from the 50 MB L2; each member costs
// five correctly rounded divisions, a square root and an arccos, each a
// sequence of f64 instructions. The first design ran one warp of 32 threads
// per (center, frame), lane r walking ring r (about 6r members) member by
// member: lanes 25-31 idle at 25 rings, the warp as long as its longest
// ring's chain (357 us at the 12.5k shapes on the card). This design spreads
// the work by member (see winding_profile_kernel: 261 us with 2 frames a
// block, 254 with 4). Each ring's angles are added in one fixed order, so
// every run repeats bit for bit and the plain version adds in that order
// too (JAX differences two prefix sums instead, which changes the profile by
// rounding only). Every decision (the sign of the cross product, the
// clipping, the ring-count tests) uses explicitly rounded operations, so
// counts and types equal the plain version's.

template <typename T>
struct CenterPlane {
  T e1[3], e2[3], n[3], nn, e11, e22;
};

// The unit 2-D direction of vertex `id`'s velocity on the center's plane
// (project_to_plane, express_on_basis, then v / where(|v| > 0, |v|, 1)).
template <typename T>
__device__ __forceinline__ void unit_direction(const T* __restrict__ v, int32_t id,
                                               const CenterPlane<T>& p, T& ux, T& uy) {
  const T* x = v + 3 * static_cast<int64_t>(id);
  const T vel[3] = {x[0], x[1], x[2]};
  const T s = p.nn > T(0) ? rn_div(dot3(vel, p.n), p.nn) : T(0);
  T proj[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) proj[d] = rn_sub(vel[d], rn_mul(s, p.n[d]));
  const T a = rn_div(dot3(proj, p.e1), p.e11);
  const T b = rn_div(dot3(proj, p.e2), p.e22);
  const T nrm = rn_sqrt(rn_add(rn_mul(a, a), rn_mul(b, b)));
  const T den = nrm > T(0) ? nrm : T(1);
  ux = rn_div(a, den);
  uy = rn_div(b, den);
}

// ops/winding.py:78 _signed_angle: arccos(clip(u1.u2, -1, 1)), negated when
// the cross product is negative (a NaN dot stays NaN, as jnp.clip keeps it).
template <typename T>
__device__ __forceinline__ T signed_angle(T ax, T ay, T bx, T by) {
  T dot = rn_add(rn_mul(ax, bx), rn_mul(ay, by));
  dot = dot < T(-1) ? T(-1) : (dot > T(1) ? T(1) : dot);
  const T ang = acos(dot);
  const T cross = rn_sub(rn_mul(ax, by), rn_mul(ay, bx));
  return cross < T(0) ? -ang : ang;
}

// The winding profiles, the work spread by member. A block of kThreads takes
// one center for a group of frames (frames
// blockIdx.y, blockIdx.y + gridDim.y, ...). The center's ring members are
// staged in shared memory in chunks of up to `cap` (one chunk, loaded once
// for every frame of the group, whenever the row fits): their vertex ids and
// each member's successor in its ring (the next member, the ring's first for
// its last member, itself for a ring of one). For each frame and chunk:
//   1. thread i writes member i's unit direction (unit_direction) to shared
//      memory; a barrier;
//   2. thread i writes the signed angle from member i to its successor
//      (signed_angle; 0 for a ring of one member), the successor's direction
//      from shared memory or, outside the chunk, formed again from v; a
//      barrier;
//   3. a warp per ring adds the ring's angles: lane l takes its members l,
//      l + 32, ... in order (its partial sum kept in shared memory across
//      chunks); a barrier.
// Then each ring's warp closes the 32 partials with the fixed-order warp_sum
// and thread 0 counts the persistent rings. Directions and angles are the
// first design's expressions; only the order of each ring's sum changed.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    winding_profile_kernel(const T* __restrict__ v_world,
                           const int32_t* __restrict__ order,
                           const int32_t* __restrict__ bounds,
                           const T* __restrict__ e1s, const T* __restrict__ e2s,
                           int32_t* __restrict__ counts, int32_t* __restrict__ types,
                           T* __restrict__ w_out, int64_t n_frames, int64_t n_vert,
                           int64_t width, int64_t levels, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ux = reinterpret_cast<T*>(smem);                         // cap
  T* uy = ux + cap;                                           // cap
  T* ang = uy + cap;                                          // cap
  T* lanesum = ang + cap;                                     // levels * 32
  T* wsh = lanesum + levels * 32;                             // levels
  int32_t* ids = reinterpret_cast<int32_t*>(wsh + levels);    // cap
  int32_t* succ = ids + cap;                                  // cap
  int32_t* bnd = succ + cap;                                  // levels + 1
  const int64_t u = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  CenterPlane<T> p;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    p.e1[d] = e1s[u * 3 + d];
    p.e2[d] = e2s[u * 3 + d];
  }
  cross3(p.e1, p.e2, p.n);
  p.nn = dot3(p.n, p.n);
  p.e11 = dot3(p.e1, p.e1);
  p.e22 = dot3(p.e2, p.e2);
  const int32_t* ord = order + u * width;
  for (int64_t i = tid; i <= levels; i += kThreads) bnd[i] = bounds[u * (levels + 1) + i];
  __syncthreads();
  const int32_t begin = bnd[0];
  const int32_t total = bnd[levels] - begin;
  const int32_t n_chunks = (total + cap - 1) / cap;
  int32_t loaded = -1;
  const T two_pi = T(2.0 * 3.141592653589793);
  for (int64_t t = blockIdx.y; t < n_frames; t += gridDim.y) {
    const T* v = v_world + t * n_vert * 3;
    T* w = w_out + (u * n_frames + t) * levels;
    for (int64_t i = tid; i < levels * 32; i += kThreads) lanesum[i] = T(0);
    __syncthreads();
    for (int32_t chunk = 0; chunk < n_chunks; ++chunk) {
      const int32_t c0 = begin + chunk * cap;
      const int32_t n = total - chunk * cap < cap ? total - chunk * cap : cap;
      if (chunk != loaded) {  // ids[i] and succ[i] are read by thread i only
        for (int32_t i = tid; i < n; i += kThreads) {
          const int32_t j = c0 + i;
          int lo = 0, hi = static_cast<int>(levels);  // bnd[lo] <= j < bnd[hi]
          while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (bnd[mid] <= j) lo = mid;
            else hi = mid;
          }
          ids[i] = ord[j];
          succ[i] = j + 1 < bnd[lo + 1] ? j + 1 : bnd[lo];
        }
        loaded = chunk;
      }
      for (int32_t i = tid; i < n; i += kThreads) unit_direction(v, ids[i], p, ux[i], uy[i]);
      __syncthreads();
      for (int32_t i = tid; i < n; i += kThreads) {
        const int32_t k = succ[i];
        T a = T(0);
        if (k != c0 + i) {
          T kx, ky;
          if (k >= c0 && k < c0 + n) {
            kx = ux[k - c0];
            ky = uy[k - c0];
          } else {
            unit_direction(v, ord[k], p, kx, ky);
          }
          a = signed_angle(ux[i], uy[i], kx, ky);
        }
        ang[i] = a;
      }
      __syncthreads();
      for (int64_t r = warp; r < levels; r += kWarps) {
        const int32_t first = bnd[r];
        const int32_t lo = first > c0 ? first : c0;
        const int32_t hi = bnd[r + 1] < c0 + n ? bnd[r + 1] : c0 + n;
        if (lo >= hi) continue;  // uniform across the warp
        const int32_t d = lo - first;
        int32_t j = first + lane + (d > lane ? (d - lane + 31) / 32 * 32 : 0);
        T acc = lanesum[r * 32 + lane];
        for (; j < hi; j += 32) acc = rn_add(acc, ang[j - c0]);
        lanesum[r * 32 + lane] = acc;
      }
      __syncthreads();
    }
    for (int64_t r = warp; r < levels; r += kWarps) {
      const T sum = warp_sum(lanesum[r * 32 + lane]);
      if (lane == 0) {
        const T wr = rn_div(sum, two_pi);
        wsh[r] = wr;
        w[r] = wr;
      }
    }
    __syncthreads();
    if (tid == 0) {
      // ops/winding.py:173 _count_and_type: ring 1 fixes the type, then the
      // count runs while |w - type| <= 0.001, from ring 2 on.
      const T w0 = wsh[0];
      int32_t typ = 0;
      if (w0 >= T(0.99) && w0 <= T(1.01)) typ = 1;
      else if (w0 >= T(-1.01) && w0 <= T(-0.99)) typ = -1;
      int32_t count = 0;
      if (typ != 0) {
        const T target = static_cast<T>(typ);
        const T lo = rn_sub(target, T(0.001)), hi = rn_add(target, T(0.001));
        count = 1;
        for (int64_t r = 1; r < levels && wsh[r] >= lo && wsh[r] <= hi; ++r) ++count;
      }
      counts[u * n_frames + t] = count;
      types[u * n_frames + t] = typ;
    }
    __syncthreads();  // wsh and lanesum serve the next frame
  }
}

// Members a block stages at once, and frames a block: 4 was the fastest of
// 1, 2, 4 and 8 on the card (f64 at the 12.5k shapes: 290, 261, 254, 275 us).
constexpr int kWindingChunk = 2048;
constexpr int kWindingFrames = 4;
constexpr int64_t kMaxSharedBytes = 232448;  // a block's limit on the H100

template <typename T>
int64_t winding_shared_bytes(int64_t cap, int64_t levels) {
  return (3 * cap + 33 * levels) * static_cast<int64_t>(sizeof(T)) +
         (2 * cap + levels + 1) * 4;
}

template <typename T>
int winding_profile(const void* v_world, const void* order, const void* bounds,
                    const void* e1, const void* e2, void* counts, void* types, void* w,
                    int64_t n_centers, int64_t n_frames, int64_t n_vert, int64_t width,
                    int64_t levels, void* stream) {
  if (n_centers <= 0 || n_frames <= 0) return static_cast<int>(cudaGetLastError());
  if (n_centers > 2147483647) return static_cast<int>(cudaErrorInvalidValue);
  int64_t cap = width < kWindingChunk ? (width > 0 ? width : 1) : kWindingChunk;
  while (cap > 32 && winding_shared_bytes<T>(cap, levels) > kMaxSharedBytes) cap /= 2;
  const int64_t bytes = winding_shared_bytes<T>(cap, levels);
  if (bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        winding_profile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t groups = (n_frames + kWindingFrames - 1) / kWindingFrames;
  const dim3 grid(static_cast<unsigned int>(n_centers), frame_blocks(groups));
  winding_profile_kernel<T><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v_world), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(bounds), static_cast<const T*>(e1),
      static_cast<const T*>(e2), static_cast<int32_t*>(counts),
      static_cast<int32_t*>(types), static_cast<T*>(w), n_frames, n_vert, width,
      levels, static_cast<int>(cap));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mf

#define MF_WINDING_ENTRY_POINTS(SUFFIX, T)                                      \
  extern "C" int mf_winding_profile_##SUFFIX(                                   \
      const void* v_world, const void* order, const void* bounds,               \
      const void* e1, const void* e2, void* counts, void* types, void* w,       \
      int64_t n_centers, int64_t n_frames, int64_t n_vert, int64_t width,       \
      int64_t levels, void* stream) {                                           \
    return mf::winding_profile<T>(v_world, order, bounds, e1, e2, counts,       \
                                  types, w, n_centers, n_frames, n_vert, width, \
                                  levels, stream);                              \
  }

MF_WINDING_ENTRY_POINTS(f32, float)
MF_WINDING_ENTRY_POINTS(f64, double)
