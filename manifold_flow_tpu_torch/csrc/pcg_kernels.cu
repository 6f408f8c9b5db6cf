// PCG vector kernels (K3): the vector work of one iteration of the batched
// block-Jacobi PCG of solve/cg.py:89-102, in three launches.
//   (a) pcg_dot:       out[t] = <a_t, b_t>
//   (b) pcg_update:    x += alpha p, r -= alpha Ap, z = D^-1 r (2x2 blocks,
//                      fem/operator.py:132-143), rz_new = <r, z>, rr = <r, r>
//   (c) pcg_direction: p = z + beta p
// Vectors are (T, 2N) with dof = vertex + N * alpha; dinv is (T, N, 2, 2).
// alpha = rz / pAp and beta = rz_new / rz are formed per frame inside the
// kernels, with the zero guards of solve/cg.py:93-100. Per-frame sums close
// in a fixed order (common.cuh's block reduction; pcg_update's partials in
// slice order), so no float atomics and no run-to-run drift in the
// iteration count.
//
// pcg_dot is bound by reading its two operands once: 4.9 MB in f32 at the
// bench shapes (97 x 6272), 19.5 MB at the 12.5k shapes (97 x 25088), 1.5
// and 5.8 us at 3.35 TB/s. Its first design ran one block of 256 threads a
// frame, each thread with one 4- or 8-byte load pair in flight, and, on the
// wrapper's clock, lost to torch.linalg.vecdot (the device clock later
// showed vecdot's two kernels 3-6x slower). This design keeps one block a
// frame but streams the row in 16-byte vectors, kDotUnroll of them per
// operand loaded before any multiply-add, four times the bytes in flight a
// thread. A thread-block cluster of up to 8 blocks a frame, the partials
// added in rank 0's shared memory, was slower on the card at the bench and
// 12.5k row lengths (a cluster barrier cost more than the extra blocks
// gained), so it is not here: it needs a measured workload with longer
// rows to come back. One launch, no global scratch, no second pass.
//
// pcg_update is bound by its bytes: it reads x, r, p, Ap and D^-1 and
// writes x, r, z, 21.9 MB in f32 at the bench shapes, 87.6 MB at 12.5k
// (6.5 and 26.2 us). Its first design ran one block of 256 threads a frame
// (97 blocks on 132 SMs), each thread with a few scalar loads in flight:
// about 0.8 MB in flight on the card, where 3.35 TB/s needs about 2 MB to
// cover the memory's latency. This design runs S blocks a frame (S from N:
// one 16-byte group of vertices a thread), each thread loading every
// operand of its group (x, r, p, Ap at rows v and v + N, and D^-1) in
// 16-byte vectors before any arithmetic. Each block writes its partial
// r.z and r.r to a (T, S) scratch; the last block of a frame to finish,
// found through an integer ticket per frame, adds the S partials in index
// order and resets the ticket (common.cuh close_slices, which K11
// coarse_prolong_dot shares). No float atomics: repeated calls are bitwise
// equal. The ticket costs one integer atomic a block; a cluster of the S
// blocks reducing through distributed shared memory would cost a cluster
// barrier, which on this card took more than pcg_dot's whole time.
//
// pcg_dot and pcg_update take the type A of their per-frame sums as a
// second template argument: A = T is the solve's default instance, and
// <float, double> the precise one of solve_cg(precise_dots=True)
// (solve/cg.py:30-47 `_dot`): every product of the float operands is formed
// and summed in double, the partials of pcg_update's slices are double, and
// the frame's sum is rounded to float once, where it is written. The
// operands, their loads and the launch shapes are those of the float
// instance, so it moves the same bytes; its reductions' shared scratch
// doubles (64 bytes a block for block_sum, 2 KB for close_slices).
#include "common.cuh"

namespace mf {

constexpr int kDotUnroll = 4;  // vectors a thread loads per operand at once

// part[u] += x[k] y[k] over k in [lo, hi), thread i taking k = lo + i,
// lo + i + kThreads, ..., kDotUnroll of them loaded before any is used.
// P is T (scalar elements) or Vec16<T>::type (16-byte vectors); A is the
// accumulator type.
template <typename P, typename A>
__device__ __forceinline__ void dot_slice(const P* __restrict__ x,
                                          const P* __restrict__ y, int64_t lo,
                                          int64_t hi, A* part) {
  for (int64_t k0 = lo + threadIdx.x; k0 < hi; k0 += kThreads * kDotUnroll) {
    P xs[kDotUnroll] = {};
    P ys[kDotUnroll] = {};
#pragma unroll
    for (int u = 0; u < kDotUnroll; ++u) {
      const int64_t k = k0 + u * kThreads;
      if (k < hi) {
        xs[u] = __ldg(x + k);
        ys[u] = __ldg(y + k);
      }
    }
#pragma unroll
    for (int u = 0; u < kDotUnroll; ++u) {
      if (k0 + u * kThreads < hi) part[u] = dot_acc(xs[u], ys[u], part[u]);
    }
  }
}

// out[t] = <a_t, b_t>, one block per frame. When a_t and b_t sit at the
// same offset from a 16-byte boundary (always in the solve), the whole
// vectors go first, then the elements up to the first boundary, then the
// last few; otherwise the row goes element by element. The order of every
// sum is fixed by n and that offset, so repeated calls are bitwise equal.
template <typename T, typename A>
__global__ void __launch_bounds__(kThreads)
    dot_kernel(const T* a, const T* b, T* out, int64_t n) {
  using V = typename Vec16<T>::type;
  constexpr int W = kVecWidth<T>;
  __shared__ A scratch[kWarps];
  const int64_t t = blockIdx.x;
  const T* at = a + t * n;
  const T* bt = b + t * n;
  A part[kDotUnroll] = {};
  const bool paired = ((reinterpret_cast<uintptr_t>(at) ^
                        reinterpret_cast<uintptr_t>(bt)) & 15) == 0;
  if (paired) {
    const int64_t head = head_to_16(at, n);
    const int64_t n_vec = (n - head) / W;
    dot_slice(reinterpret_cast<const V*>(at + head),
              reinterpret_cast<const V*>(bt + head), int64_t(0), n_vec, part);
    dot_slice(at, bt, int64_t(0), head, part);
    dot_slice(at, bt, head + n_vec * W, n, part);
  } else {
    dot_slice(at, bt, int64_t(0), n, part);
  }
  A acc = (part[0] + part[1]) + (part[2] + part[3]);
  acc = block_sum(acc, scratch);
  if (threadIdx.x == 0) out[t] = static_cast<T>(acc);
}

// One vertex's step of pcg_update, the first design's expression: x += alpha
// p, r -= alpha Ap, z = D^-1 r, and its terms of r.z and r.r, formed in the
// accumulator type A (the cast is nothing where A = T).
template <typename T, typename A>
__device__ __forceinline__ void update_vertex(T alpha, T& x1, T& x2, T& r1,
                                              T& r2, T p1, T p2, T ap1, T ap2,
                                              const T* d, T& z1, T& z2,
                                              A& acc_rz, A& acc_rr) {
  x1 += alpha * p1;
  x2 += alpha * p2;
  r1 = r1 - alpha * ap1;
  r2 = r2 - alpha * ap2;
  z1 = d[0] * r1 + d[1] * r2;
  z2 = d[2] * r1 + d[3] * r2;
  const A a1 = static_cast<A>(r1), a2 = static_cast<A>(r2);
  acc_rz += a1 * static_cast<A>(z1) + a2 * static_cast<A>(z2);
  acc_rr += a1 * a1 + a2 * a2;
}

// pcg_update on vertices [lo, hi) of one frame, one element at a time,
// thread i taking lo + i, lo + i + kThreads, ...
template <typename T, typename A>
__device__ __forceinline__ void update_scalar(T alpha, T* xt, T* rt, T* zt,
                                              const T* pt, const T* apt,
                                              const T* dt, int64_t n_vert,
                                              int64_t lo, int64_t hi,
                                              A& acc_rz, A& acc_rr) {
  for (int64_t v = lo + threadIdx.x; v < hi; v += kThreads) {
    const int64_t w = v + n_vert;
    T x1 = xt[v], x2 = xt[w], r1 = rt[v], r2 = rt[w], z1, z2;
    T d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = dt[v * 4 + k];
    update_vertex(alpha, x1, x2, r1, r2, pt[v], pt[w], apt[v], apt[w], d, z1,
                  z2, acc_rz, acc_rr);
    xt[v] = x1;
    xt[w] = x2;
    rt[v] = r1;
    rt[w] = r2;
    zt[v] = z1;
    zt[w] = z2;
  }
}

// Block (s, t) updates slice s of frame t (and of every gridDim.y-th frame
// after it). When the five vectors' rows sit at one offset from a 16-byte
// boundary, N * sizeof(T) is a multiple of 16 and D^-1 is aligned (always
// in the solve), each thread takes groups of W = 16 / sizeof(T) vertices
// in vectors, the slices cutting the groups evenly; slice 0 also takes the
// elements before the first boundary and slice S - 1 those after the last
// group. Otherwise the slices cut the vertices and go one at a time. The
// block's r.z and r.r close in slice order (common.cuh close_slices). The
// order of every sum is fixed by N, S and the offsets.
template <typename T, typename A>
__global__ void __launch_bounds__(kThreads)
    update_kernel(T* __restrict__ x, T* __restrict__ r, T* __restrict__ z,
                  const T* __restrict__ p, const T* __restrict__ ap,
                  const T* __restrict__ dinv, const T* __restrict__ rz,
                  const T* __restrict__ pap, T* __restrict__ rz_new,
                  T* __restrict__ rr, A* __restrict__ part,
                  unsigned int* __restrict__ ticket, int64_t n_frames,
                  int64_t n_vert) {
  using V = typename Vec16<T>::type;
  constexpr int W = kVecWidth<T>;
  __shared__ A scratch[kWarps];
  const int n_slices = static_cast<int>(gridDim.x);
  const int s = static_cast<int>(blockIdx.x);
  for (int64_t t = blockIdx.y; t < n_frames; t += gridDim.y) {
    const T pa = pap[t];
    const T alpha = (pa != T(0)) ? rz[t] / pa : T(0);
    const int64_t off = t * 2 * n_vert;
    T* xt = x + off;
    T* rt = r + off;
    T* zt = z + off;
    const T* pt = p + off;
    const T* apt = ap + off;
    const T* dt = dinv + t * n_vert * 4;
    A acc_rz = A(0), acc_rr = A(0);
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(xt) & 15;
    const bool vec = (reinterpret_cast<uintptr_t>(rt) & 15) == a0 &&
                     (reinterpret_cast<uintptr_t>(zt) & 15) == a0 &&
                     (reinterpret_cast<uintptr_t>(pt) & 15) == a0 &&
                     (reinterpret_cast<uintptr_t>(apt) & 15) == a0 &&
                     (reinterpret_cast<uintptr_t>(dt) & 15) == 0 &&
                     ((n_vert * static_cast<int64_t>(sizeof(T))) & 15) == 0;
    if (vec) {
      const int64_t head = head_to_16(xt, n_vert);
      const int64_t n_vec = (n_vert - head) / W;
      const int64_t per = (n_vec + n_slices - 1) / n_slices;
      const int64_t g_hi = (s + 1) * per < n_vec ? (s + 1) * per : n_vec;
      for (int64_t k = s * per + threadIdx.x; k < g_hi; k += kThreads) {
        const int64_t v = head + k * W;
        const int64_t w = v + n_vert;
        V xv[2], rv[2], pv[2], apv[2], dv[4];
        xv[0] = *reinterpret_cast<const V*>(xt + v);
        xv[1] = *reinterpret_cast<const V*>(xt + w);
        rv[0] = *reinterpret_cast<const V*>(rt + v);
        rv[1] = *reinterpret_cast<const V*>(rt + w);
        pv[0] = __ldg(reinterpret_cast<const V*>(pt + v));
        pv[1] = __ldg(reinterpret_cast<const V*>(pt + w));
        apv[0] = __ldg(reinterpret_cast<const V*>(apt + v));
        apv[1] = __ldg(reinterpret_cast<const V*>(apt + w));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dv[q] = __ldg(reinterpret_cast<const V*>(dt + v * 4) + q);
        }
        T x1[W], x2[W], r1[W], r2[W], p1[W], p2[W], ap1[W], ap2[W], d[4 * W];
        T z1[W], z2[W];
        unpack(xv[0], x1);
        unpack(xv[1], x2);
        unpack(rv[0], r1);
        unpack(rv[1], r2);
        unpack(pv[0], p1);
        unpack(pv[1], p2);
        unpack(apv[0], ap1);
        unpack(apv[1], ap2);
#pragma unroll
        for (int q = 0; q < 4; ++q) unpack(dv[q], d + q * W);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          update_vertex(alpha, x1[j], x2[j], r1[j], r2[j], p1[j], p2[j],
                        ap1[j], ap2[j], d + 4 * j, z1[j], z2[j], acc_rz,
                        acc_rr);
        }
        *reinterpret_cast<V*>(xt + v) = pack(x1);
        *reinterpret_cast<V*>(xt + w) = pack(x2);
        *reinterpret_cast<V*>(rt + v) = pack(r1);
        *reinterpret_cast<V*>(rt + w) = pack(r2);
        *reinterpret_cast<V*>(zt + v) = pack(z1);
        *reinterpret_cast<V*>(zt + w) = pack(z2);
      }
      if (s == 0) {
        update_scalar(alpha, xt, rt, zt, pt, apt, dt, n_vert, int64_t(0), head,
                      acc_rz, acc_rr);
      }
      if (s == n_slices - 1) {
        update_scalar(alpha, xt, rt, zt, pt, apt, dt, n_vert, head + n_vec * W,
                      n_vert, acc_rz, acc_rr);
      }
    } else {
      const int64_t per = (n_vert + n_slices - 1) / n_slices;
      const int64_t hi = (s + 1) * per < n_vert ? (s + 1) * per : n_vert;
      update_scalar(alpha, xt, rt, zt, pt, apt, dt, n_vert, s * per, hi, acc_rz,
                    acc_rr);
    }
    const A sums[2] = {block_sum(acc_rz, scratch), block_sum(acc_rr, scratch)};
    T* const outs[2] = {rz_new, rr};
    close_slices(sums, outs, part, ticket, t);
  }
}

template <typename T>
__global__ void direction_kernel(T* __restrict__ p, const T* __restrict__ z,
                                 const T* __restrict__ rz_new,
                                 const T* __restrict__ rz_old,
                                 int64_t n_frames, int64_t n_dof) {
  const int64_t i = global_index();
  if (i >= n_frames * n_dof) return;
  const int64_t t = i / n_dof;
  const T old = rz_old[t];
  const T beta = (old != T(0)) ? rz_new[t] / old : T(0);
  p[i] = z[i] + beta * p[i];
}

template <typename T, typename A>
int pcg_dot(const void* a, const void* b, void* out, int64_t n_frames,
            int64_t n, void* stream) {
  if (n_frames > 0) {
    dot_kernel<T, A><<<static_cast<unsigned int>(n_frames), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A>
int pcg_update(void* x, void* r, void* z, const void* p, const void* ap,
               const void* dinv, const void* rz, const void* pap, void* rz_new,
               void* rr, void* part, void* ticket, int64_t n_frames,
               int64_t n_vert, int64_t n_slices, void* stream) {
  if (n_frames > 0) {
    if (n_slices < 1 || n_slices > kMaxSlices) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid(static_cast<unsigned int>(n_slices), frame_blocks(n_frames));
    update_kernel<T, A><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<T*>(x), static_cast<T*>(r), static_cast<T*>(z),
        static_cast<const T*>(p), static_cast<const T*>(ap),
        static_cast<const T*>(dinv), static_cast<const T*>(rz),
        static_cast<const T*>(pap), static_cast<T*>(rz_new),
        static_cast<T*>(rr), static_cast<A*>(part),
        static_cast<unsigned int*>(ticket), n_frames, n_vert);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pcg_direction(void* p, const void* z, const void* rz_new,
                  const void* rz_old, int64_t n_frames, int64_t n_dof,
                  void* stream) {
  const int64_t n = n_frames * n_dof;
  if (n > 0) {
    direction_kernel<T><<<blocks_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<T*>(p), static_cast<const T*>(z),
        static_cast<const T*>(rz_new), static_cast<const T*>(rz_old),
        n_frames, n_dof);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mf

// The dot and the update in three instances: float and double (A = T), and
// float with double sums (f32acc64, solve_cg's precise_dots); the direction,
// which sums nothing, in the first two.
#define MF_PCG_SUM_ENTRY_POINTS(SUFFIX, T, A)                                 \
  extern "C" int mf_pcg_dot_##SUFFIX(const void* a, const void* b, void* out, \
                                     int64_t n_frames, int64_t n,             \
                                     void* stream) {                          \
    return mf::pcg_dot<T, A>(a, b, out, n_frames, n, stream);                 \
  }                                                                           \
  extern "C" int mf_pcg_update_##SUFFIX(                                      \
      void* x, void* r, void* z, const void* p, const void* ap,               \
      const void* dinv, const void* rz, const void* pap, void* rz_new,        \
      void* rr, void* part, void* ticket, int64_t n_frames, int64_t n_vert,   \
      int64_t n_slices, void* stream) {                                       \
    return mf::pcg_update<T, A>(x, r, z, p, ap, dinv, rz, pap, rz_new, rr,    \
                                part, ticket, n_frames, n_vert, n_slices,     \
                                stream);                                      \
  }

#define MF_PCG_DIRECTION_ENTRY_POINT(SUFFIX, T)                               \
  extern "C" int mf_pcg_direction_##SUFFIX(                                   \
      void* p, const void* z, const void* rz_new, const void* rz_old,         \
      int64_t n_frames, int64_t n_dof, void* stream) {                        \
    return mf::pcg_direction<T>(p, z, rz_new, rz_old, n_frames, n_dof,        \
                                stream);                                      \
  }

MF_PCG_SUM_ENTRY_POINTS(f32, float, float)
MF_PCG_SUM_ENTRY_POINTS(f64, double, double)
MF_PCG_SUM_ENTRY_POINTS(f32acc64, float, double)
MF_PCG_DIRECTION_ENTRY_POINT(f32, float)
MF_PCG_DIRECTION_ENTRY_POINT(f64, double)
