// Shared helpers for the package's CUDA kernels (built for sm_90a).
//
// Kernels launch on the caller's stream with kThreads threads per block (K8's
// with fewer, coarse_kernels.cu kAssembleThreads). Reductions are deterministic: a fixed shuffle tree inside each warp,
// then warp 0 sums the per-warp partials in warp order. No float atomics are
// used anywhere, so results (and PCG iteration counts) repeat run to run.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mf {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

__device__ __forceinline__ int64_t global_index() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

// Sum of v over a block of kThreads threads; the result is valid in thread 0.
// `scratch` is kWarps elements of shared memory. Ends with a barrier, so the
// same scratch can serve the next call.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T total = T(0);
  if (warp == 0) {
    total = warp_sum(lane < kWarps ? scratch[lane] : T(0));
  }
  __syncthreads();
  return total;
}

// 16-byte vectors, the widest load a thread makes: four floats or two
// doubles. A pointer into a row may not be 16-byte aligned (a row starts at
// t * n elements, and a tensor may carry a storage offset), so the kernels
// that stream rows in vectors take the elements before the first 16-byte
// boundary (`head_to_16`) and after the last whole vector one at a time.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};
template <typename T>
constexpr int kVecWidth = 16 / static_cast<int>(sizeof(T));

// Elements of T from p to the first 16-byte boundary at or after it, at most
// n (p is aligned to sizeof(T), as every tensor's data is).
template <typename T>
__device__ __forceinline__ int64_t head_to_16(const T* p, int64_t n) {
  const int64_t h = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / sizeof(T);
  return h < n ? h : n;
}

// A 16-byte vector's components into o[0..W), and back.
__device__ __forceinline__ void unpack(float4 v, float* o) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void unpack(double2 v, double* o) {
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ float4 pack(const float* o) {
  return make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ double2 pack(const double* o) {
  return make_double2(o[0], o[1]);
}

// o[0..4) to p, which is 16-byte aligned (a row of 4 values in a tensor the
// wrapper allocated): one float4, or two double2.
__device__ __forceinline__ void store4(float* p, const float* o) {
  *reinterpret_cast<float4*>(p) = pack(o);
}
__device__ __forceinline__ void store4(double* p, const double* o) {
  reinterpret_cast<double2*>(p)[0] = pack(o);
  reinterpret_cast<double2*>(p)[1] = pack(o + 2);
}

// acc + <a, b> for one element or one 16-byte vector, in component order.
__device__ __forceinline__ float dot_acc(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ double dot_acc(double a, double b, double acc) {
  return fma(a, b, acc);
}
__device__ __forceinline__ float dot_acc(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ double dot_acc(double2 a, double2 b, double acc) {
  acc = fma(a.x, b.x, acc);
  return fma(a.y, b.y, acc);
}
// The same in a float64 accumulator from float operands (the precise
// instances of K3 and K11): a product of two floats is exact in double, so
// the fused multiply-add rounds only where the separate add would.
__device__ __forceinline__ double dot_acc(float a, float b, double acc) {
  return fma(static_cast<double>(a), static_cast<double>(b), acc);
}
__device__ __forceinline__ double dot_acc(float4 a, float4 b, double acc) {
  acc = dot_acc(a.x, b.x, acc);
  acc = dot_acc(a.y, b.y, acc);
  acc = dot_acc(a.z, b.z, acc);
  return dot_acc(a.w, b.w, acc);
}

// Explicitly rounded arithmetic for every expression that decides something
// discrete (a mask, an argmax, a class code, a ring count): nvcc would
// otherwise contract a*b+c into fused multiply-adds, move results by an ulp
// and flip a decision against the plain torch version, which evaluates each
// operation separately.
__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rn_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double rn_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rn_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float rn_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double rn_div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float rn_fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double rn_fma(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float rn_sqrt(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double rn_sqrt(double a) { return __dsqrt_rn(a); }

// (a0 b0 + a1 b1) + a2 b2, each operation rounded on its own.
template <typename T>
__device__ __forceinline__ T dot3(const T* a, const T* b) {
  return rn_add(rn_add(rn_mul(a[0], b[0]), rn_mul(a[1], b[1])), rn_mul(a[2], b[2]));
}

template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* out) {
  out[0] = rn_sub(rn_mul(a[1], b[2]), rn_mul(a[2], b[1]));
  out[1] = rn_sub(rn_mul(a[2], b[0]), rn_mul(a[0], b[2]));
  out[2] = rn_sub(rn_mul(a[0], b[1]), rn_mul(a[1], b[0]));
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

// Frames run over gridDim.y with a stride, so any frame count launches.
inline unsigned int frame_blocks(int64_t n_frames) {
  return static_cast<unsigned int>(n_frames < 65535 ? n_frames : 65535);
}

// The most blocks a frame of the kernels that cut each frame into slices
// (pcg_update, coarse_prolong_dot); kernels._lib.MAX_SLICES.
constexpr int kMaxSlices = 128;

// Closes NV per-frame sums that the S = gridDim.x blocks of frame t (block
// s = blockIdx.x holding slice s) computed in parts: acc is the block's
// partials, valid in thread 0 (block_sum's result). With one slice thread 0
// writes out[i][t] = acc[i]. Otherwise each block stores its partials at
// part[(t S + s) NV + i] and takes the frame's integer ticket; the last block
// to arrive adds the S partials in slice order, writes out[i][t] and leaves
// the ticket at 0 for the next launch. No float atomics: the sums repeat bit
// for bit. The partials and the closing sum are of the accumulator type A;
// the write to out (of type O) is the only rounding where O is narrower.
// Every thread of the block calls it; with S > 1 it ends with a barrier, so
// its shared memory serves the next frame.
template <typename A, typename O, int NV>
__device__ __forceinline__ void close_slices(const A (&acc)[NV],
                                             O* const (&out)[NV],
                                             A* __restrict__ part,
                                             unsigned int* __restrict__ ticket,
                                             int64_t t) {
  __shared__ A closing[NV * kMaxSlices];
  __shared__ bool last;
  const int n_slices = static_cast<int>(gridDim.x);
  const int s = static_cast<int>(blockIdx.x);
  if (n_slices == 1) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i) out[i][t] = static_cast<O>(acc[i]);
    }
    return;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) part[(t * n_slices + s) * NV + i] = acc[i];
    __threadfence();  // the partials are visible before the ticket moves
    last = atomicAdd(ticket + t, 1u) == static_cast<unsigned int>(n_slices - 1);
  }
  __syncthreads();
  if (last && threadIdx.x < 32) {
    __threadfence();
    const A* pf = part + t * n_slices * NV;
    for (int k = threadIdx.x; k < NV * n_slices; k += 32) closing[k] = __ldcg(pf + k);
    __syncwarp();
    if (threadIdx.x == 0) {
      A sum[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) sum[i] = A(0);
      for (int k = 0; k < n_slices; ++k) {
#pragma unroll
        for (int i = 0; i < NV; ++i) sum[i] += closing[NV * k + i];
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) out[i][t] = static_cast<O>(sum[i]);
      ticket[t] = 0u;  // ready for the next launch
    }
  }
  __syncthreads();
}

}  // namespace mf
