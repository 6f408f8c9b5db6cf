// PCG vector kernels (K3): the vector work of one iteration of the batched
// block-Jacobi PCG of solve/cg.py:89-102, in three launches.
//   (a) pcg_dot:       out[t] = <a_t, b_t>
//   (b) pcg_update:    x += alpha p, r -= alpha Ap, z = D^-1 r (2x2 blocks,
//                      fem/operator.py:132-143), rz_new = <r, z>, rr = <r, r>
//   (c) pcg_direction: p = z + beta p
// Vectors are (T, 2N) with dof = vertex + N * alpha; dinv is (T, N, 2, 2).
// alpha = rz / pAp and beta = rz_new / rz are formed per frame inside the
// kernels, with the zero guards of solve/cg.py:93-100. Per-frame sums close
// with the fixed-order block reduction of common.cuh, so no float atomics
// and no run-to-run drift in the iteration count.
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
#include "common.cuh"

namespace mf {

constexpr int kDotUnroll = 4;  // vectors a thread loads per operand at once

// part[u] += x[k] y[k] over k in [lo, hi), thread i taking k = lo + i,
// lo + i + kThreads, ..., kDotUnroll of them loaded before any is used.
// P is T (scalar elements) or Vec16<T>::type (16-byte vectors).
template <typename P, typename T>
__device__ __forceinline__ void dot_slice(const P* __restrict__ x,
                                          const P* __restrict__ y, int64_t lo,
                                          int64_t hi, T* part) {
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
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dot_kernel(const T* a, const T* b, T* out, int64_t n) {
  using V = typename Vec16<T>::type;
  constexpr int W = kVecWidth<T>;
  __shared__ T scratch[kWarps];
  const int64_t t = blockIdx.x;
  const T* at = a + t * n;
  const T* bt = b + t * n;
  T part[kDotUnroll] = {};
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
  T acc = (part[0] + part[1]) + (part[2] + part[3]);
  acc = block_sum(acc, scratch);
  if (threadIdx.x == 0) out[t] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    update_kernel(T* __restrict__ x, T* __restrict__ r, T* __restrict__ z,
                  const T* __restrict__ p, const T* __restrict__ ap,
                  const T* __restrict__ dinv, const T* __restrict__ rz,
                  const T* __restrict__ pap, T* __restrict__ rz_new,
                  T* __restrict__ rr, int64_t n_vert) {
  __shared__ T scratch[kWarps];
  const int64_t t = blockIdx.x;
  const T pa = pap[t];
  const T alpha = (pa != T(0)) ? rz[t] / pa : T(0);
  const int64_t off = t * 2 * n_vert;
  T* xt = x + off;
  T* rt = r + off;
  T* zt = z + off;
  const T* pt = p + off;
  const T* apt = ap + off;
  const T* dt = dinv + t * n_vert * 4;
  T acc_rz = T(0), acc_rr = T(0);
  for (int64_t v = threadIdx.x; v < n_vert; v += kThreads) {
    const int64_t w = v + n_vert;
    xt[v] += alpha * pt[v];
    xt[w] += alpha * pt[w];
    const T r1 = rt[v] - alpha * apt[v];
    const T r2 = rt[w] - alpha * apt[w];
    rt[v] = r1;
    rt[w] = r2;
    const T* d = dt + v * 4;
    const T z1 = d[0] * r1 + d[1] * r2;
    const T z2 = d[2] * r1 + d[3] * r2;
    zt[v] = z1;
    zt[w] = z2;
    acc_rz += r1 * z1 + r2 * z2;
    acc_rr += r1 * r1 + r2 * r2;
  }
  acc_rz = block_sum(acc_rz, scratch);
  acc_rr = block_sum(acc_rr, scratch);
  if (threadIdx.x == 0) {
    rz_new[t] = acc_rz;
    rr[t] = acc_rr;
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

template <typename T>
int pcg_dot(const void* a, const void* b, void* out, int64_t n_frames,
            int64_t n, void* stream) {
  if (n_frames > 0) {
    dot_kernel<T><<<static_cast<unsigned int>(n_frames), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pcg_update(void* x, void* r, void* z, const void* p, const void* ap,
               const void* dinv, const void* rz, const void* pap, void* rz_new,
               void* rr, int64_t n_frames, int64_t n_vert, void* stream) {
  if (n_frames > 0) {
    update_kernel<T><<<static_cast<unsigned int>(n_frames), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<T*>(x), static_cast<T*>(r), static_cast<T*>(z),
        static_cast<const T*>(p), static_cast<const T*>(ap),
        static_cast<const T*>(dinv), static_cast<const T*>(rz),
        static_cast<const T*>(pap), static_cast<T*>(rz_new),
        static_cast<T*>(rr), n_vert);
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

#define MF_PCG_ENTRY_POINTS(SUFFIX, T)                                        \
  extern "C" int mf_pcg_dot_##SUFFIX(const void* a, const void* b, void* out, \
                                     int64_t n_frames, int64_t n,             \
                                     void* stream) {                          \
    return mf::pcg_dot<T>(a, b, out, n_frames, n, stream);                    \
  }                                                                           \
  extern "C" int mf_pcg_update_##SUFFIX(                                      \
      void* x, void* r, void* z, const void* p, const void* ap,               \
      const void* dinv, const void* rz, const void* pap, void* rz_new,        \
      void* rr, int64_t n_frames, int64_t n_vert, void* stream) {             \
    return mf::pcg_update<T>(x, r, z, p, ap, dinv, rz, pap, rz_new, rr,       \
                             n_frames, n_vert, stream);                       \
  }                                                                           \
  extern "C" int mf_pcg_direction_##SUFFIX(                                   \
      void* p, const void* z, const void* rz_new, const void* rz_old,         \
      int64_t n_frames, int64_t n_dof, void* stream) {                        \
    return mf::pcg_direction<T>(p, z, rz_new, rz_old, n_frames, n_dof,        \
                                stream);                                      \
  }

MF_PCG_ENTRY_POINTS(f32, float)
MF_PCG_ENTRY_POINTS(f64, double)
