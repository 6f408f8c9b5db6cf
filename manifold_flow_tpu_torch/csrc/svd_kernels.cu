// K18 `jacobi_svd<double>`: the SVD of S4's small square factor by
// one-sided (Hestenes) Jacobi, float64, in one persistent cooperative launch.
//
// Replaces: no TPU kernel (the JAX package calls jnp.linalg.svd, B15). It
// takes the place of cuSOLVER's block-Jacobi gesvdj launches on the R factor
// of the movie's thin QR (ops/svd.py): G = R^T (m x m, m <= 1024) is rotated
// column pair by column pair until every pair is orthogonal to
// |g_i.g_j| <= tol |g_i| |g_j| (tol = m eps, dgesvj's rule), accumulating W,
// so that G W = U Sigma. No Gram matrix is formed: every rotation is computed
// from the dot products of the columns as they stand.
//
// Bound: ~9 m^3 float64 operations a sweep, which at m = 390 is ~16 us at
// 34 TFLOP/s; in fact the chain of ~m dependent steps a sweep (each a warp's
// three dot products, their shuffle reductions and two reciprocal square
// roots) and a grid barrier a round. Design: the columns are cut into 2p
// blocks of b = 8, each block's columns together in memory; a round-robin
// tournament pairs the blocks, and CTAs 0..p-1 take a pair each a round
// (2p - 1 rounds a sweep, a grid barrier after each: 2 + sweeps (2p - 1)
// barriers a launch). Such a CTA copies its pair's 2b columns of G into
// shared memory (cp.async, L2 only): warp k keeps column k of the first block
// in registers while the b columns of the second pass by, b steps of b
// disjoint pairs, and in each sweep's first round the pairs inside each
// block come first; it logs each step's rotations. CTAs p..p+q-1 hold W by
// rows, in slices of 8 rows, and during each round replay the rotations
// the pairs logged in the round before, so W's 2m^2 operations a sweep stay
// off the chain of steps. Every dot product is a warp's fixed-order sum with
// a butterfly reduction (every lane the same bits), and the schedule is
// fixed, so two launches give the same bits (C1). A sweep in which no CTA
// rotated ends the loop: the test is on the device, with no host read. Then
// each column's norm is its singular value; U, sigma and W come out sorted
// by descending sigma (ties in column order), and the number of sweeps run
// is written to a device integer. Measured on an H100 at m = 390 (11
// sweeps): 5.2 ms; 6.4 with W multiplied by each round's rotations inside
// the rotating CTAs; 9.7 with blocks of 16 (13 CTAs, few enough for one
// thread-block cluster) whatever the barrier; slower too with columns handed
// warp to warp through step counts instead of a block barrier a step, or
// with the W CTAs left out of the barrier. The squares of G's entries, of its
// column norms and their products must stay in float64's range: the wrapper
// (kernels/svd.py) scales G by a power of two to max |G| in [0.5, 1), so only
// columns below ~1e-75 of the largest can underflow them.

#include <cmath>
#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace mf {

constexpr int kJacobiMaxSweeps = 30;  // dgesvj's NSWEEP
// Control words: [0] arrivals at the grid barrier (never reset), [1 + s] the
// CTAs that rotated a pair in sweep s. Zeroed before each launch.
constexpr int kJacobiCtrl = 1 + kJacobiMaxSweeps;

struct JacobiArgs {
  const double* g_in;   // (m, m): column j of G at g_in + j m
  double* g;            // (2 p b, m): G's columns, zero past m
  double* w;            // (m, 2 p b): W by rows
  double* vlog;         // (2, p, 4b^2): each pair's rotation log of a round, two rounds
  int* vflag;           // (2, p): whether that pair rotated
  double* sigma;        // (2 p b,): the column norms, unsorted
  unsigned int* ctrl;   // kJacobiCtrl words
  double* u_out;        // (m, m): column c of U at u_out + c m
  double* s_out;        // (m,)
  double* w_out;        // (m, m): column c of W at w_out + c m
  int32_t* sweeps_out;  // (1,)
  int m, p, q;          // q: the CTAs that update W, after the p that rotate G
  double tol2;          // tol^2
};

// Every CTA of the cooperative launch waits here until all have arrived;
// their global writes before it are visible to all after it. The arrival
// count only grows: the `episode`-th barrier is passed when it reaches
// episode * gridDim.x.
__device__ __forceinline__ void grid_barrier(unsigned int* count, unsigned int& episode) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int target = ++episode * gridDim.x;
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> arrivals(*count);
    __threadfence();
    arrivals.fetch_add(1u, cuda::memory_order_release);
    while (arrivals.load(cuda::memory_order_acquire) < target) {
    }
  }
  __syncthreads();
}

// 16 bytes from global to shared memory, asynchronously, through L2 only.
__device__ __forceinline__ void copy_async16(double* smem_dst, const double* src) {
  const unsigned int dst = static_cast<unsigned int>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

// n doubles (n even, both ends 16-byte aligned) into shared memory, as one
// group of asynchronous copies.
__device__ __forceinline__ void copy_block_async(double* smem_dst, const double* src, int n) {
  for (int i = 2 * threadIdx.x; i < n; i += 2 * blockDim.x) copy_async16(smem_dst + i, src + i);
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void store_block(double* dst, const double* smem_src, int n) {
  for (int i = threadIdx.x; 2 * i < n; i += blockDim.x) {
    reinterpret_cast<double2*>(dst)[i] = reinterpret_cast<const double2*>(smem_src)[i];
  }
}

// Sum over the warp, the same bits in every lane (a butterfly: each lane adds
// the same two values at each level).
__device__ __forceinline__ double warp_allsum(double v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// The round-robin (circle method) tournament of n items, n even: pair k of
// the n / 2 in round r of the n - 1.
__device__ __forceinline__ void round_robin(int n, int r, int k, int& first, int& second) {
  const int ring = n - 1;
  if (k == 0) {
    first = ring;
    second = r;
  } else {
    first = (r + k) % ring;
    second = (r - k + ring) % ring;
  }
}

// A column of m rows in a warp's registers: lane l holds rows l + 32 k.
template <int R>
__device__ __forceinline__ void load_column(double (&x)[R], const double* col, int m,
                                            int lane) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int row = lane + 32 * k;
    x[k] = row < m ? col[row] : 0.0;
  }
}

template <int R>
__device__ __forceinline__ void store_column(const double (&x)[R], double* col, int m,
                                             int lane) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int row = lane + 32 * k;
    if (row < m) col[row] = x[k];
  }
}

// One Jacobi rotation of the pair (x, y) held by a warp: false, and both left
// as they are, where (x.y)^2 <= tol^2 |x|^2 |y|^2 already; else the rotation
// (cs, sn) that makes them orthogonal, applied: with d = |y|^2 - |x|^2,
// e = 2 x.y and h = |d| + sqrt(d^2 + e^2), tan(theta) = sign(d) e / h (the
// smaller root of t^2 + 2 (d / e) t - 1 = 0), so cs = h / sqrt(h^2 + e^2)
// and sn = sign(d) e / sqrt(h^2 + e^2): two reciprocal square roots and no
// division. Each dot product: two partial sums a lane (even and odd k), then
// the butterfly.
template <int R>
__device__ __forceinline__ bool rotate_pair(double (&x)[R], double (&y)[R], double tol2,
                                            double& cs, double& sn) {
  double xx[2] = {0.0, 0.0}, yy[2] = {0.0, 0.0}, xy[2] = {0.0, 0.0};
#pragma unroll
  for (int k = 0; k < R; ++k) {
    xx[k & 1] = fma(x[k], x[k], xx[k & 1]);
    yy[k & 1] = fma(y[k], y[k], yy[k & 1]);
    xy[k & 1] = fma(x[k], y[k], xy[k & 1]);
  }
  const double a = warp_allsum(xx[0] + xx[1]);
  const double b = warp_allsum(yy[0] + yy[1]);
  const double c = warp_allsum(xy[0] + xy[1]);
  if (!(c * c > tol2 * (a * b))) return false;
  const double d = b - a, e = 2.0 * c, f = d * d + e * e;
  const double h = fabs(d) + f * rsqrt(f);
  const double z = rsqrt(h * h + e * e);
  cs = h * z;
  sn = copysign(1.0, d) * e * z;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const double xk = x[k], yk = y[k];
    x[k] = cs * xk - sn * yk;
    y[k] = sn * xk + cs * yk;
  }
  return true;
}

// Where a CTA logs the rotation (cs, sn) of the pair its warp w took in a
// step of a round: the pairs inside the blocks (round 0 of a sweep, b - 1
// steps), then those across (b steps); (1, 0) where a pair did not rotate.
template <int B>
__host__ __device__ constexpr int log_slot(bool inside, int step, int w) {
  return inside ? step * B + w : (B - 1) * B + step * B + w;
}

// W's rows [row0, row1) through the rotations that the p pairs of round r
// logged (those that rotated), in the order the pairs made them: each
// (row, pair) a thread's 2b entries of the row, the threads of a warp on one
// pair's log, staged in shared memory.
template <int B>
__device__ __forceinline__ void update_w(const JacobiArgs& a, double* logs, int* flags,
                                         int slot, int r, int row0, int row1) {
  constexpr int b = B, n2 = 2 * B, half = B / 2;
  const int p = a.p, nblk = 2 * p, nc = nblk * b;
  copy_block_async(logs, a.vlog + static_cast<int64_t>(slot) * p * n2 * n2, p * n2 * n2);
  for (int k = threadIdx.x; k < p; k += blockDim.x) flags[k] = __ldcg(a.vflag + slot * p + k);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const int rows = row1 - row0;
  for (int item = threadIdx.x; item < rows * p; item += blockDim.x) {
    const int k = item / rows, row = row0 + item % rows;
    if (!flags[k]) continue;
    int bx, by;
    round_robin(nblk, r, k, bx, by);
    double* wr = a.w + static_cast<int64_t>(row) * nc;
    const double2* rot = reinterpret_cast<const double2*>(logs + k * n2 * n2);
    double e[n2];
#pragma unroll
    for (int c = 0; c < n2; ++c) e[c] = __ldcg(wr + (c < b ? bx * b + c : by * b + c - b));
    const auto turn = [&](int slot_of, int i, int j) {
      const double2 cssn = rot[slot_of];
      const double ei = e[i], ej = e[j];
      e[i] = cssn.x * ei - cssn.y * ej;
      e[j] = cssn.y * ei + cssn.x * ej;
    };
    if (r == 0) {
#pragma unroll
      for (int s = 0; s < b - 1; ++s) {
#pragma unroll
        for (int w = 0; w < b; ++w) {
          int i = 0, j = 0;
          round_robin(b, s, w % half, i, j);
          const int base = (w / half) * b;
          turn(log_slot<B>(true, s, w), base + i, base + j);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < b; ++s) {
#pragma unroll
      for (int w = 0; w < b; ++w) turn(log_slot<B>(false, s, w), w, b + (w + s) % b);
    }
#pragma unroll
    for (int c = 0; c < n2; ++c) wr[c < b ? bx * b + c : by * b + c - b] = e[c];
  }
  __syncthreads();
}

// R: the rows a lane holds, m <= 32 R. Blocks of B columns (even), 32 B
// threads. CTAs 0..p-1 rotate G, a pair of blocks each a round; CTAs p..p+q-1
// hold W's rows in q slices and, during each round, replay on them the
// rotations the pairs logged in the round before.
template <int R, int B>
__global__ void __launch_bounds__(32 * B) jacobi_svd_kernel(JacobiArgs a) {
  constexpr int b = B, n2 = 2 * B;
  extern __shared__ __align__(16) double smem[];
  __shared__ int rotated_round, rotated_sweep, stop;
  const int m = a.m, nblk = 2 * a.p, bm = b * m, nc = nblk * b;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool rotates_g = static_cast<int>(blockIdx.x) < a.p;
  double* gs = smem;          // G's role: the pair's 2b columns of G, m rows each
  double* rlog = gs + n2 * m; // and the round's rotations (log_slot)
  int* flags = reinterpret_cast<int*>(smem + a.p * n2 * n2);  // W's role (logs at smem)
  const int slice = (m + a.q - 1) / a.q;
  const int row0 = rotates_g ? 0 : min(m, (static_cast<int>(blockIdx.x) - a.p) * slice);
  const int row1 = min(m, row0 + slice);
  unsigned int episode = 0;   // grid barriers passed (thread 0's count)

  // G's columns (zero past m) and W = I.
  const int64_t total = static_cast<int64_t>(nc) * m;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t col = i / m, row = i - col * m;
    a.g[i] = col < m ? a.g_in[i] : 0.0;
    a.w[i] = i / nc == i % nc ? 1.0 : 0.0;
  }
  grid_barrier(a.ctrl, episode);

  int sweep = 0, rounds = 0, last_r = 0;
  while (sweep < kJacobiMaxSweeps) {
    if (threadIdx.x == 0) rotated_sweep = 0;
    for (int r = 0; r < nblk - 1; ++r, ++rounds) {
      const int slot = rounds & 1;
      if (!rotates_g) {
        if (rounds > 0) update_w<B>(a, smem, flags, slot ^ 1, last_r, row0, row1);
      } else {
        int bx, by;
        round_robin(nblk, r, blockIdx.x, bx, by);
        // Block q's b columns lie together at q b m: local columns 0..b-1
        // are block bx's, b..2b-1 block by's.
        double* gx = a.g + static_cast<int64_t>(bx) * bm;
        double* gy = a.g + static_cast<int64_t>(by) * bm;
        copy_block_async(gs, gx, bm);
        copy_block_async(gs + bm, gy, bm);
        if (threadIdx.x == 0) rotated_round = 0;
        asm volatile("cp.async.wait_group 0;\n" ::);
        __syncthreads();

        bool rotated = false;  // uniform in each warp
        double x[R], y[R], cs, sn;
        if (r == 0) {
          // The pairs inside each block, once a sweep: b - 1 steps, b / 2
          // pairs a block and step.
          const int half = b / 2;
          for (int s = 0; s < b - 1; ++s) {
            const int base = (warp / half) * b;
            int i, j;
            round_robin(b, s, warp % half, i, j);
            load_column(x, gs + (base + i) * m, m, lane);
            load_column(y, gs + (base + j) * m, m, lane);
            const bool rot = rotate_pair(x, y, a.tol2, cs, sn);
            if (rot) {
              store_column(x, gs + (base + i) * m, m, lane);
              store_column(y, gs + (base + j) * m, m, lane);
              rotated = true;
            }
            if (lane == 0) {
              reinterpret_cast<double2*>(rlog)[log_slot<B>(true, s, warp)] =
                  rot ? make_double2(cs, sn) : make_double2(1.0, 0.0);
            }
            __syncthreads();
          }
        }
        // The b x b pairs across the two blocks: warp k keeps column k of the
        // first in registers, and column (k + s) mod b of the second passes
        // by in step s.
        load_column(x, gs + warp * m, m, lane);
        for (int s = 0; s < b; ++s) {
          const int cy = b + (warp + s) % b;
          load_column(y, gs + cy * m, m, lane);
          const bool rot = rotate_pair(x, y, a.tol2, cs, sn);
          if (rot) {
            store_column(y, gs + cy * m, m, lane);
            rotated = true;
          }
          if (lane == 0) {
            reinterpret_cast<double2*>(rlog)[log_slot<B>(false, s, warp)] =
                rot ? make_double2(cs, sn) : make_double2(1.0, 0.0);
          }
          __syncthreads();
        }
        store_column(x, gs + warp * m, m, lane);
        if (rotated && lane == 0) rotated_round = 1;
        __syncthreads();

        store_block(gx, gs, bm);
        store_block(gy, gs + bm, bm);
        if (rotated_round) {
          store_block(a.vlog + (static_cast<int64_t>(slot) * a.p + blockIdx.x) * n2 * n2, rlog,
                      2 * (2 * b - 1) * b);
        }
        if (threadIdx.x == 0) {
          a.vflag[slot * a.p + blockIdx.x] = rotated_round;
          if (rotated_round) rotated_sweep = 1;
          if (r == nblk - 2 && rotated_sweep) atomicAdd(a.ctrl + 1 + sweep, 1u);
        }
      }
      grid_barrier(a.ctrl, episode);
      last_r = r;
    }
    if (threadIdx.x == 0) {
      stop = *reinterpret_cast<volatile unsigned int*>(a.ctrl + 1 + sweep) == 0u;
    }
    ++sweep;
    __syncthreads();
    if (stop) break;
  }
  // The last round's rotations of W.
  if (!rotates_g) update_w<B>(a, smem, flags, (rounds - 1) & 1, last_r, row0, row1);

  // Each column's norm, then its rank by descending norm (ties in column
  // order) and its place in the outputs.
  const int warps = blockDim.x >> 5;
  const int first = blockIdx.x * warps + warp, every = gridDim.x * warps;
  for (int j = first; j < m; j += every) {
    const double* col = a.g + static_cast<int64_t>(j) * m;
    double ss = 0.0;
    for (int row = lane; row < m; row += 32) {
      const double v = __ldcg(col + row);
      ss = fma(v, v, ss);
    }
    ss = warp_allsum(ss);
    if (lane == 0) a.sigma[j] = sqrt(ss);
  }
  grid_barrier(a.ctrl, episode);
  for (int j = first; j < m; j += every) {
    const double sj = __ldcg(a.sigma + j);
    int rank = 0;
    for (int i = lane; i < m; i += 32) {
      const double si = __ldcg(a.sigma + i);
      rank += (si > sj || (si == sj && i < j)) ? 1 : 0;
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      rank += __shfl_xor_sync(0xffffffffu, rank, offset);
    }
    const double* g = a.g + static_cast<int64_t>(j) * m;
    double* u = a.u_out + static_cast<int64_t>(rank) * m;
    double* wo = a.w_out + static_cast<int64_t>(rank) * m;
    for (int row = lane; row < m; row += 32) {
      // A column that is exactly zero gets the unit vector of its index.
      u[row] = sj > 0.0 ? __ldcg(g + row) / sj : (row == j ? 1.0 : 0.0);
      wo[row] = __ldcg(a.w + static_cast<int64_t>(row) * nc + j);
    }
    if (lane == 0) a.s_out[rank] = sj;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.sweeps_out = sweep;
}

// Shared memory a CTA: G's role, a pair of blocks of G and its rotation log;
// W's role, the p pairs' logs and their flags.
size_t jacobi_smem(int64_t m, int64_t b, int64_t p) {
  const int64_t g_role = 2 * b * m + 4 * b * b, w_role = p * 4 * b * b + (p + 1) / 2;
  return static_cast<size_t>(g_role > w_role ? g_role : w_role) * sizeof(double);
}

template <int R, int B>
int launch_jacobi(JacobiArgs args, cudaStream_t stream) {
  const auto kernel = jacobi_svd_kernel<R, B>;
  const int threads = 32 * B;
  const size_t smem = jacobi_smem(args.m, B, args.p);
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // Every CTA must be resident at once for the grid barrier.
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  // W's rows in slices of 8, as many slices as resident CTAs allow.
  args.q = static_cast<int>(min(static_cast<int64_t>(per_sm) * sms - args.p,
                                static_cast<int64_t>((args.m + 7) / 8)));
  if (args.q < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(args.p + args.q), dim3(threads), params, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

int64_t jacobi_svd_workspace(int64_t m, int64_t b, int64_t p) {
  const int64_t columns = 2 * p * b, nv = 2 * p * 4 * b * b;
  return (2 * columns * m + columns + nv) * static_cast<int64_t>(sizeof(double)) +
         (2 * p + kJacobiCtrl) * static_cast<int64_t>(sizeof(int));
}

int jacobi_svd(const void* g, void* u, void* s, void* w, void* sweeps, void* work,
               int64_t m, int64_t b, int64_t p, double tol, void* stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  if (m > 32 * 32 || b != 8 || p < 1 || 2 * p * b < m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t columns = 2 * p * b, nv = 2 * p * 4 * b * b;
  auto* base = static_cast<double*>(work);
  JacobiArgs args{};
  args.g_in = static_cast<const double*>(g);
  args.g = base;
  args.w = base + columns * m;
  args.sigma = base + 2 * columns * m;
  args.vlog = base + 2 * columns * m + columns;
  args.ctrl = reinterpret_cast<unsigned int*>(base + 2 * columns * m + columns + nv);
  args.vflag = reinterpret_cast<int*>(args.ctrl + kJacobiCtrl);
  args.u_out = static_cast<double*>(u);
  args.s_out = static_cast<double*>(s);
  args.w_out = static_cast<double*>(w);
  args.sweeps_out = static_cast<int32_t*>(sweeps);
  args.m = static_cast<int>(m);
  args.p = static_cast<int>(p);
  args.tol2 = tol * tol;
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(args.ctrl, 0, kJacobiCtrl * sizeof(unsigned int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (m <= 32 * 4) return launch_jacobi<4, 8>(args, st);
  if (m <= 32 * 8) return launch_jacobi<8, 8>(args, st);
  if (m <= 32 * 13) return launch_jacobi<13, 8>(args, st);
  if (m <= 32 * 16) return launch_jacobi<16, 8>(args, st);
  return launch_jacobi<32, 8>(args, st);
}

}  // namespace mf

extern "C" int64_t mf_jacobi_svd_workspace_f64(int64_t m, int64_t b, int64_t p) {
  return mf::jacobi_svd_workspace(m, b, p);
}

extern "C" int mf_jacobi_svd_f64(const void* g, void* u, void* s, void* w, void* sweeps,
                                 void* work, int64_t m, int64_t b, int64_t p, double tol,
                                 void* stream) {
  return mf::jacobi_svd(g, u, s, w, sweeps, work, m, b, p, tol, stream);
}
