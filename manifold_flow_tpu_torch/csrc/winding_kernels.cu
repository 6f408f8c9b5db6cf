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
// Bound on this card: arithmetic latency, not bytes. v_world is read once
// from device memory (7.3 MB in f64 at the bench shapes, about 2.5 us at
// 3.35 TB/s) and the members' re-reads, up to U*T*N*24 B, come from the
// 50 MB L2; each member costs an f64 arccos and two divisions.
// Design: one warp per (center, frame); lane r sums ring r (and r + 32, ...)
// member by member in sorted order, so every run adds in the same order and
// repeats bit for bit, and the plain version adds in that order too (JAX
// differences two prefix sums instead, which changes the profile by rounding
// only). Lane 0 then counts the persistent rings. Every decision (the sign
// of the cross product, the clipping, the ring-count tests) uses explicitly
// rounded operations, so counts and types equal the plain version's.

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

template <typename T>
__global__ void winding_profile_kernel(
    const T* __restrict__ v_world, const int32_t* __restrict__ order,
    const int32_t* __restrict__ bounds, const T* __restrict__ e1s,
    const T* __restrict__ e2s, int32_t* __restrict__ counts,
    int32_t* __restrict__ types, T* __restrict__ w_out, int64_t n_frames,
    int64_t n_vert, int64_t width, int64_t levels) {
  const int64_t u = blockIdx.x;
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
  const int32_t* b = bounds + u * (levels + 1);
  const T two_pi = T(2.0 * 3.141592653589793);
  for (int64_t t = blockIdx.y; t < n_frames; t += gridDim.y) {
    const T* v = v_world + t * n_vert * 3;
    T* w = w_out + (u * n_frames + t) * levels;
    for (int64_t r = threadIdx.x; r < levels; r += blockDim.x) {
      const int32_t first = b[r], end = b[r + 1];
      T sum = T(0), closure = T(0);
      if (end - first >= 1) {
        T fx, fy;
        unit_direction(v, ord[first], p, fx, fy);
        T px = fx, py = fy;
        for (int32_t i = first + 1; i < end; ++i) {
          T cx, cy;
          unit_direction(v, ord[i], p, cx, cy);
          sum = rn_add(sum, signed_angle(px, py, cx, cy));
          px = cx;
          py = cy;
        }
        if (end - first >= 2) closure = signed_angle(px, py, fx, fy);
      }
      w[r] = rn_div(rn_add(sum, closure), two_pi);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      // ops/winding.py:173 _count_and_type: ring 1 fixes the type, then the
      // count runs while |w - type| <= 0.001, from ring 2 on.
      const T w0 = w[0];
      int32_t typ = 0;
      if (w0 >= T(0.99) && w0 <= T(1.01)) typ = 1;
      else if (w0 >= T(-1.01) && w0 <= T(-0.99)) typ = -1;
      int32_t count = 0;
      if (typ != 0) {
        const T target = static_cast<T>(typ);
        const T lo = rn_sub(target, T(0.001)), hi = rn_add(target, T(0.001));
        count = 1;
        for (int64_t r = 1; r < levels && w[r] >= lo && w[r] <= hi; ++r) ++count;
      }
      counts[u * n_frames + t] = count;
      types[u * n_frames + t] = typ;
    }
    __syncthreads();
  }
}

template <typename T>
int winding_profile(const void* v_world, const void* order, const void* bounds,
                    const void* e1, const void* e2, void* counts, void* types, void* w,
                    int64_t n_centers, int64_t n_frames, int64_t n_vert, int64_t width,
                    int64_t levels, void* stream) {
  if (n_centers > 0 && n_frames > 0) {
    const dim3 grid(static_cast<unsigned int>(n_centers), frame_blocks(n_frames));
    winding_profile_kernel<T><<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v_world), static_cast<const int32_t*>(order),
        static_cast<const int32_t*>(bounds), static_cast<const T*>(e1),
        static_cast<const T*>(e2), static_cast<int32_t*>(counts),
        static_cast<int32_t*>(types), static_cast<T*>(w), n_frames, n_vert, width,
        levels);
  }
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
