// Streamline kernels of the S6 stage: the per-frame next-hop graph (K13)
// and the walks over it (K14: walk lengths, and the packing of walks into
// one flat id buffer). Layouts follow the JAX package:
//   unit        (N, D, 3)   projected unit edge vectors to the 1-ring
//                           (frame-independent, built once per mesh)
//   neighbors   (N, D)      1-ring vertex ids, -1 padded
//   rules       (N, D)      int32 hop rule of each 1-ring slot (built once
//                           per mesh): kHopAdvance, -1, or the row of
//                           `corners` of the one triangle it shares
//   corners     (K, 4)      (bx, by, cx, cy) of each such triangle on the
//                           vertex's tangent basis (built once per mesh)
//   v_world     (T, N, 3)   world velocity vectors
//   next        (T, N)      int32 frame-local next vertex; a halting vertex
//                           points to itself
// Every decision (the argmax over the 1-ring, dmax > 0, the per-frame half
// of the boundary triangle test) is computed with the explicitly rounded
// operations of common.cuh, in the JAX expression order, so `next` equals
// the plain torch version's. The C entry points return the cudaError_t of
// the launches.
#include <cmath>

#include "common.cuh"

namespace mf {

// ------------------------------------------------------------------ K13
// The next hop of every (frame, vertex) (ops/streamline.py:133
// _next_hop_tables with :242 _hop_graph, B10): the 1-ring neighbour whose
// projected unit edge vector has the largest dot product with the vertex's
// velocity (the first on ties, as argmax takes it), kept when that dot is
// positive and, for a boundary vertex (fewer than 6 incident cells), when
// the two share at least 2 cells or the velocity points strictly inside
// their one shared triangle (:98 _boundary_triangle_test).
//
// Bound on this card: memory traffic. At 12.5k vertices x 97 frames in f64
// a call reads v_world once (29.2 MB) and the 1-ring tables once (2.4 MB)
// and writes next (4.9 MB): 10.8 us at 3.35 TB/s.
//
// Design: one thread per (vertex, F consecutive frames). All that does not
// depend on the frame is done once per mesh outside the kernel
// (kernels.streams.hop_tables): the unit edges, and for each 1-ring slot
// its hop rule (kHopAdvance where the vertex is interior or shares 2 cells
// with that neighbour, -1 where it shares none or their triangle is
// degenerate, else a row of `corners`): the shared-cell scan and the
// triangle's corners on the vertex's tangent basis, counter-clockwise. A
// thread loads its vertex's 1-ring ids, rules and unit edges into registers
// once (the first kHopSlots slots; a wider 1-ring reads the rest each
// frame), then for each of its frames reads its 3 velocity components
// (coalesced across the warp), takes the D dot products and the argmax,
// and where the chosen slot's rule names a row, takes the velocity on the
// tangent basis and its three orientation tests against that row's
// corners; it writes next coalesced. F is 8 where that still gives every
// SM 4 blocks, else 4; the registers are capped for 5 blocks of 128
// threads an SM. What holds it back on an H100: the per-frame dot products
// and compares of every slot (about 24 us at 12.5k vertices with the
// boundary test left out), then the boundary lanes, which their warps wait
// for.
constexpr int kHopThreads = 128;
constexpr int kHopMinBlocks = 5;
constexpr int kHopSlots = 6;      // 1-ring slots held in registers
constexpr int32_t kHopAdvance = -2;

template <typename T>
__device__ __forceinline__ T cross2(T ax, T ay, T bx, T by) {
  return rn_sub(rn_mul(ax, by), rn_mul(ay, bx));
}

// The per-frame half of ops/streamline.py:98 _boundary_triangle_test: the
// velocity `vel` on the tangent basis e = (e1, e2) points strictly inside
// the triangle whose other corners are (bx, by) and (cx, cy) = `corner`
// (counter-clockwise, the vertex at the origin).
template <typename T>
__device__ __forceinline__ bool points_inside(const T* __restrict__ corner,
                                              const T* __restrict__ e, const T* vel) {
  const T bx = corner[0], by = corner[1], cx = corner[2], cy = corner[3];
  const T vx = rn_div(dot3(vel, e), dot3(e, e));
  const T vy = rn_div(dot3(vel, e + 3), dot3(e + 3, e + 3));
  return cross2(bx, by, vx, vy) > T(0) &&
         cross2(rn_sub(cx, bx), rn_sub(cy, by), rn_sub(vx, bx), rn_sub(vy, by)) > T(0) &&
         cross2(-cx, -cy, rn_sub(vx, cx), rn_sub(vy, cy)) > T(0);
}

// Slot d's value of a register array `a` of SLOTS entries, d < SLOTS
// (a select over the unrolled slots keeps `a` in registers).
template <int SLOTS, typename V>
__device__ __forceinline__ V slot_of(const V (&a)[SLOTS], int d) {
  V out = a[0];
#pragma unroll
  for (int k = 1; k < SLOTS; ++k) out = d == k ? a[k] : out;
  return out;
}

template <typename T, int F>
__global__ void __launch_bounds__(kHopThreads, kHopMinBlocks) next_hop_kernel(
    const T* __restrict__ unit, const T* __restrict__ v_world,
    const int32_t* __restrict__ neighbors, const int32_t* __restrict__ rules,
    const T* __restrict__ corners, const T* __restrict__ basis, int32_t* __restrict__ next,
    int64_t n_frames, int64_t n_vert, int64_t width) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kHopThreads + threadIdx.x;
  if (v >= n_vert) return;
  const int64_t row = v * width;
  int32_t nb[kHopSlots], rule[kHopSlots];
  T u[kHopSlots][3];
#pragma unroll
  for (int d = 0; d < kHopSlots; ++d) {
    const bool in_row = d < width;
    nb[d] = in_row ? neighbors[row + d] : -1;
    rule[d] = in_row ? rules[row + d] : -1;
#pragma unroll
    for (int k = 0; k < 3; ++k) u[d][k] = in_row ? unit[(row + d) * 3 + k] : T(0);
  }
  const int64_t n_groups = (n_frames + F - 1) / F;
  for (int64_t g = blockIdx.y; g < n_groups; g += gridDim.y) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int64_t t = g * F + f;
      if (t >= n_frames) break;
      const T* vel = v_world + (t * n_vert + v) * 3;
      const T vv[3] = {vel[0], vel[1], vel[2]};
      // argmax in torch.argmax's order: a NaN is the largest (nothing
      // replaces it), ties to the first index; padded slots are -inf, so
      // an all-padded row gives 0.
      T best = -INFINITY;
      int best_d = 0;
#pragma unroll
      for (int d = 0; d < kHopSlots; ++d) {
        if (d < width) {
          const T val = nb[d] != -1 ? dot3(u[d], vv) : T(-INFINITY);
          if (best == best && !(val <= best)) {  // val NaN or above best
            best = val;
            best_d = d;
          }
        }
      }
      for (int64_t d = kHopSlots; d < width; ++d) {  // a 1-ring wider than kHopSlots
        const int32_t id = neighbors[row + d];
        const T val = id != -1 ? dot3(unit + (row + d) * 3, vv) : T(-INFINITY);
        if (best == best && !(val <= best)) {
          best = val;
          best_d = static_cast<int>(d);
        }
      }
      const bool in_regs = best_d < kHopSlots;
      const int32_t nb_best = in_regs ? slot_of(nb, best_d) : neighbors[row + best_d];
      const int32_t cand = nb_best != -1 ? nb_best : 0;
      bool advance = best > T(0);
      if (advance) {
        const int32_t r = in_regs ? slot_of(rule, best_d) : rules[row + best_d];
        if (r != kHopAdvance) {
          advance = r >= 0 && points_inside(corners + 4 * static_cast<int64_t>(r),
                                            basis + v * 6, vv);
        }
      }
      next[t * n_vert + v] = advance ? cand : static_cast<int32_t>(v);
    }
  }
}

template <typename T, int F>
cudaError_t launch_next_hop(const void* unit, const void* v_world, const void* neighbors,
                            const void* rules, const void* corners, const void* basis,
                            void* next, int64_t n_frames, int64_t n_vert, int64_t width,
                            cudaStream_t s) {
  const int64_t groups = (n_frames + F - 1) / F;
  const dim3 grid(static_cast<unsigned int>((n_vert + kHopThreads - 1) / kHopThreads),
                  static_cast<unsigned int>(groups < 65535 ? groups : 65535));
  next_hop_kernel<T, F><<<grid, kHopThreads, 0, s>>>(
      static_cast<const T*>(unit), static_cast<const T*>(v_world),
      static_cast<const int32_t*>(neighbors), static_cast<const int32_t*>(rules),
      static_cast<const T*>(corners), static_cast<const T*>(basis),
      static_cast<int32_t*>(next), n_frames, n_vert, width);
  return cudaGetLastError();
}

// F = 8 frames a thread where that still gives every SM 4 blocks or more,
// else 4 (more blocks for a small mesh).
template <typename T>
int next_hop(const void* unit, const void* v_world, const void* neighbors,
             const void* rules, const void* corners, const void* basis, void* next,
             int64_t n_frames, int64_t n_vert, int64_t width, void* stream) {
  if (n_frames <= 0 || n_vert <= 0) return static_cast<int>(cudaGetLastError());
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const int64_t blocks8 = (n_vert + kHopThreads - 1) / kHopThreads * ((n_frames + 7) / 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      blocks8 >= 4 * static_cast<int64_t>(sms)
          ? launch_next_hop<T, 8>(unit, v_world, neighbors, rules, corners, basis, next,
                                  n_frames, n_vert, width, s)
          : launch_next_hop<T, 4>(unit, v_world, neighbors, rules, corners, basis, next,
                                  n_frames, n_vert, width, s);
  return static_cast<int>(e);
}

// ------------------------------------------------------------------ K14
// Walks over the next-hop graph (ops/streamline.py:268 _double_and_detect,
// :335, :351 and :733 _gather_packed; B11). A walk from seed s is s, f(s),
// f(f(s)), ...; its length is the first step whose vertex already occurred,
// capped at max_steps + 1. On a functional graph that step is mu + lambda
// (the tail and the cycle of the rho-shaped path), which Brent's cycle
// detection finds with O(1) state: the walk entry keeps no path.
//
// The length entry. Bound on this card: the chain of dependent loads. The
// bytes are few (next is 4.9 MB at 12.5k vertices x 97 frames, the lengths
// as much), but each step of a walk waits for the previous load, and a
// warp lasts as long as its longest walk. The first design ran one thread
// a seed chasing `next` in device memory: one L2 round trip a step. This
// design: a block takes a run of consecutive seeds of one frame, loads the
// frame's row of `next` into shared memory with 16-byte loads (shifted 0-3
// ids so that they land aligned) and runs each walk's search there, so a
// step waits on shared memory's latency; a row too large for shared memory
// (N above about 58k) is read through __ldg instead. The search runs in
// rounds: the tortoise waits at step p - 1 while the hare takes up to p
// steps, p = 1, 2, 4, ...; a walk with mu + lambda < cap is found by the
// first round with p >= max(mu + 1, lambda), so the search stops after the
// round with p >= min(cap - 1, N) (walk_limit) instead of counting steps.
// The mu pass starts from the previous round's tortoise where it lay before
// the cycle, and walks one pointer only where the cycle is a fixed point.
// Blocks of kWalkThreads threads; seeds a block from the SM count
// (trace_walks_per_block), the fastest of the shapes swept on the H100.

// The length of the walk from `s`, capped at cap, over `hop`, which maps a
// vertex's handle to its successor's (an id, or a byte offset into shared
// memory: equal handles are equal vertices).
template <class Hop>
__device__ __forceinline__ int32_t walk_length(Hop hop, int32_t s, int64_t cap,
                                               int limit) {
  int32_t tortoise = s, hare = hop(s), prev = s;
  int power = 1, lam = 1;
  while (tortoise != hare) {
    if (lam == power) {
      if (power >= limit) return static_cast<int32_t>(cap);  // mu + lambda >= cap
      prev = tortoise;
      tortoise = hare;
      power <<= 1;
      lam = 0;
    }
    hare = hop(hare);
    ++lam;
  }
  if (lam >= cap) return static_cast<int32_t>(cap);
  // mu + lambda: the first index i with x_i = x_{i + lambda}, searched from
  // the previous round's tortoise x_{power/2 - 1} where that round failed
  // with lambda <= power/2 (so its tortoise lay before the cycle), else
  // from the seed.
  const bool late = power >= 2 && 2 * lam <= power;
  int32_t a = late ? prev : s;
  int64_t len = (late ? power / 2 - 1 : 0) + lam;
  if (len >= cap) return static_cast<int32_t>(cap);
  if (lam == 1) {  // the cycle is the fixed point `tortoise`: mu is where a meets it
    while (a != tortoise && len < cap) {
      a = hop(a);
      ++len;
    }
    return static_cast<int32_t>(len);
  }
  int32_t b = a;
  for (int k = 0; k < lam; ++k) b = hop(b);
  while (a != b && len < cap) {
    a = hop(a);
    b = hop(b);
    ++len;
  }
  return static_cast<int32_t>(len);
}

// The last round of the search: the smallest power of two at or above
// min(cap - 1, n_vert), at least 1 (a walk repeats within N steps).
inline int walk_limit(int64_t cap, int64_t n_vert) {
  const int64_t need = cap - 1 < n_vert ? cap - 1 : n_vert;
  int limit = 1;
  while (limit < need) limit <<= 1;
  return limit;
}

template <bool kRowShared>
__global__ void trace_walks_kernel(const int32_t* __restrict__ next,
                                   int32_t* __restrict__ lengths, int64_t n_frames,
                                   int64_t n_vert, int64_t cap, int limit,
                                   int64_t per_block) {
  extern __shared__ __align__(16) int32_t walk_smem[];
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t s1 = s0 + per_block < n_vert ? s0 + per_block : n_vert;
  for (int64_t t = blockIdx.y; t < n_frames; t += gridDim.y) {
    const int32_t* f = next + t * n_vert;
    const int64_t head = head_to_16(f, n_vert);
    // Where kRowShared, the row starts 0-3 ids into shared memory so that its
    // 16-byte groups land aligned, and holds each successor as the byte
    // offset of its own entry: a step is one shared-memory load.
    const int shift = static_cast<int>((4 - head) & 3);
    int32_t* row = walk_smem + shift;
    if constexpr (kRowShared) {
      const int64_t n_vec = (n_vert - head) / 4;
      for (int64_t i = threadIdx.x; i < head; i += blockDim.x) {
        row[i] = 4 * (__ldg(f + i) + shift);
      }
      const int4* fv = reinterpret_cast<const int4*>(f + head);
      int4* rv = reinterpret_cast<int4*>(row + head);
      for (int64_t i = threadIdx.x; i < n_vec; i += blockDim.x) {
        const int4 q = __ldg(fv + i);
        rv[i] = make_int4(4 * (q.x + shift), 4 * (q.y + shift), 4 * (q.z + shift),
                          4 * (q.w + shift));
      }
      for (int64_t i = head + 4 * n_vec + threadIdx.x; i < n_vert; i += blockDim.x) {
        row[i] = 4 * (__ldg(f + i) + shift);
      }
      __syncthreads();
    }
    for (int64_t s = s0 + threadIdx.x; s < s1; s += blockDim.x) {
      const int32_t v = static_cast<int32_t>(s);
      int32_t len;
      if constexpr (kRowShared) {
        len = walk_length(
            [](int32_t x) {
              return *reinterpret_cast<const int32_t*>(
                  reinterpret_cast<const char*>(walk_smem) + x);
            },
            4 * (v + shift), cap, limit);
      } else {
        len = walk_length([f](int32_t x) { return __ldg(f + x); }, v, cap, limit);
      }
      lengths[t * n_vert + s] = len;
    }
    if constexpr (kRowShared) __syncthreads();  // the next frame overwrites the row
  }
}

// K14's pack entry (ops/streamline.py:733 _gather_packed; B11): walk k
// from seed seeds[k] = frame * N + vertex, lengths[k] frame-local ids,
// written to out[offsets[k] ...]. Bound on this card: the ids written
// (70.9 MB at 12.5k vertices, more than L2 holds) and the hop table read
// once. Its first design ran one thread per walk: each thread chased its
// walk through `next` in device memory, one dependent L2 load a step, and
// stored its ids one by one, so a warp's store touched up to 32 sectors.
// This design: a block takes consecutive walks, at most kPackWalks and
// fewer where more blocks are needed to fill the SMs. For each run of
// them in one frame (seeds frame-major: one run, two at a frame's edge) it
// loads that frame's row of `next` into shared memory with 16-byte loads,
// then its threads chase one walk each through shared memory, 256 walks a
// round. Where a round's walks lie back to back in `out` (offsets[k + 1] =
// offsets[k] + lengths[k], the stage's packed walks) the round's span is
// staged in windows of kPackStage ids, each thread filling its part of the
// window and keeping its place in its walk across windows (any length),
// and each window is written with coalesced stores. Elsewhere (trace_frames'
// rows, offsets seed * (max_steps + 1)) each thread stores its walk where it
// lies. A frame row that does not fit beside the window (N above about 54k)
// is read through __ldg instead. `out` is written at the walks' positions
// only, whatever the offsets.
constexpr int kPackThreads = 256;
constexpr int kPackStage = 4096;    // ids a window (16 KB; a multiple of 4, so rows stay aligned)
constexpr int kPackWalks = 1024;    // walks a block at most

template <bool kRowShared>
__global__ void __launch_bounds__(kPackThreads)
    pack_walks_kernel(const int32_t* __restrict__ next, const int64_t* __restrict__ seeds,
                      const int32_t* __restrict__ lengths,
                      const int64_t* __restrict__ offsets, int32_t* __restrict__ out,
                      int64_t n_seeds, int64_t n_vert, int64_t per_block) {
  extern __shared__ __align__(16) int32_t pack_smem[];
  int32_t* staged = pack_smem;          // [kPackStage]
  __shared__ int run_end;
  const int64_t k_begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t k_stop = k_begin + per_block < n_seeds ? k_begin + per_block : n_seeds;
  for (int64_t k0 = k_begin; k0 < k_stop;) {
    // The run [k0, k1) of walks in k0's frame.
    const int64_t frame = __ldg(seeds + k0) / n_vert;
    if (threadIdx.x == 0) run_end = static_cast<int>(k_stop - k0);
    __syncthreads();
    for (int64_t base = k0; base < k_stop; base += kPackThreads) {
      const int64_t j = base + threadIdx.x;
      const bool other = j < k_stop && __ldg(seeds + j) / n_vert != frame;
      if (other) atomicMin(&run_end, static_cast<int>(j - k0));
      if (__syncthreads_or(other)) break;
    }
    const int64_t k1 = k0 + run_end;
    const int32_t* f = next + frame * n_vert;
    // The row starts 0-3 ids into its space, so that its 16-byte groups in
    // device memory land on 16-byte groups in shared memory.
    const int64_t head = head_to_16(f, n_vert);
    int32_t* row = pack_smem + kPackStage + ((4 - head) & 3);  // [n_vert] where kRowShared
    if (kRowShared) {
      const int64_t n_vec = (n_vert - head) / 4;
      for (int64_t i = threadIdx.x; i < head; i += kPackThreads) row[i] = __ldg(f + i);
      const int4* fv = reinterpret_cast<const int4*>(f + head);
      int4* rv = reinterpret_cast<int4*>(row + head);
      for (int64_t i = threadIdx.x; i < n_vec; i += kPackThreads) rv[i] = __ldg(fv + i);
      for (int64_t i = head + 4 * n_vec + threadIdx.x; i < n_vert; i += kPackThreads) {
        row[i] = __ldg(f + i);
      }
    }
    __syncthreads();
    for (int64_t r0 = k0; r0 < k1; r0 += kPackThreads) {
      const int64_t k = r0 + threadIdx.x;
      const int64_t last = (r0 + kPackThreads < k1 ? r0 + kPackThreads : k1) - 1;
      const bool mine = k <= last;
      int32_t x = mine ? static_cast<int32_t>(__ldg(seeds + k) - frame * n_vert) : 0;
      const int32_t len = mine ? __ldg(lengths + k) : 0;
      const int64_t off = mine ? __ldg(offsets + k) : 0;
      const bool joined = !mine || k == last || __ldg(offsets + k + 1) == off + len;
      if (__syncthreads_and(joined)) {
        const int64_t span0 = __ldg(offsets + r0);
        const int64_t span1 = __ldg(offsets + last) + __ldg(lengths + last);
        int32_t j = 0;  // the next step of this thread's walk
        for (int64_t w0 = span0; w0 < span1; w0 += kPackStage) {
          const int64_t w1 = w0 + kPackStage < span1 ? w0 + kPackStage : span1;
          for (; j < len && off + j < w1; ++j) {
            staged[off + j - w0] = x;
            x = kRowShared ? row[x] : __ldg(f + x);
          }
          __syncthreads();
          for (int64_t p = w0 + threadIdx.x; p < w1; p += kPackThreads) {
            out[p] = staged[p - w0];
          }
          __syncthreads();
        }
      } else {
        int32_t* dst = out + off;
        for (int32_t j = 0; j < len; ++j) {
          dst[j] = x;
          x = kRowShared ? row[x] : __ldg(f + x);
        }
      }
    }
    __syncthreads();  // the next run overwrites row and run_end
    k0 = k1;
  }
}

constexpr int kWalkThreads = 512;

// Seeds a block of the length entry: enough blocks for about twelve an SM
// over the whole call, in whole rounds of kWalkThreads seeds, at most a
// frame's row (each block loads its frame's row once for all its seeds).
inline int64_t trace_walks_per_block(int64_t n_frames, int64_t n_vert) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const int64_t target = 12 * static_cast<int64_t>(sms) * kWalkThreads;
  const int64_t rounds = (n_frames * n_vert + target - 1) / target;
  const int64_t row = (n_vert + kWalkThreads - 1) / kWalkThreads;
  return (rounds < row ? rounds : row) * kWalkThreads;
}

int trace_walks(const void* next, void* lengths, int64_t n_frames, int64_t n_vert,
                int64_t max_steps, void* stream) {
  if (n_frames <= 0 || n_vert <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t cap = max_steps + 1;
  const int limit = walk_limit(cap, n_vert);
  const int64_t per_block = trace_walks_per_block(n_frames, n_vert);
  int device = 0, optin = 48 * 1024;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  const dim3 grid(static_cast<unsigned int>((n_vert + per_block - 1) / per_block),
                  frame_blocks(n_frames));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t with_row = static_cast<size_t>(n_vert + 3) * sizeof(int32_t);
  if (with_row > static_cast<size_t>(optin)) {
    trace_walks_kernel<false><<<grid, kWalkThreads, 0, s>>>(
        static_cast<const int32_t*>(next), static_cast<int32_t*>(lengths), n_frames,
        n_vert, cap, limit, per_block);
    return static_cast<int>(cudaGetLastError());
  }
  if (with_row > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t e = cudaFuncSetAttribute(
        trace_walks_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(with_row));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  trace_walks_kernel<true><<<grid, kWalkThreads, with_row, s>>>(
      static_cast<const int32_t*>(next), static_cast<int32_t*>(lengths), n_frames, n_vert,
      cap, limit, per_block);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRowShared>
cudaError_t launch_pack_walks(const void* next, const void* seeds, const void* lengths,
                              const void* offsets, void* out, int64_t n_seeds,
                              int64_t n_vert, int64_t per_block, size_t smem,
                              cudaStream_t s) {
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t e = cudaFuncSetAttribute(
        pack_walks_kernel<kRowShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = (n_seeds + per_block - 1) / per_block;
  pack_walks_kernel<kRowShared><<<static_cast<unsigned int>(blocks), kPackThreads, smem, s>>>(
      static_cast<const int32_t*>(next), static_cast<const int64_t*>(seeds),
      static_cast<const int32_t*>(lengths), static_cast<const int64_t*>(offsets),
      static_cast<int32_t*>(out), n_seeds, n_vert, per_block);
  return cudaGetLastError();
}

// Walks a block: enough blocks for about eight an SM, in whole rounds of
// kPackThreads walks, at most kPackWalks (a block loads its frame row once
// for all of them): 256 at the bench shapes, 512 at 12.5k vertices, each
// the fastest of 256, 512 and 1024 there on the H100 (windows of 2048 and
// 8192 ids were slower at 12.5k).
inline int64_t pack_walks_per_block(int64_t n_seeds) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const int64_t target = 8 * static_cast<int64_t>(sms) * kPackThreads;
  const int64_t rounds = (n_seeds + target - 1) / target;
  const int64_t per_block = rounds * kPackThreads;
  return per_block < kPackWalks ? per_block : kPackWalks;
}

int pack_walks(const void* next, const void* seeds, const void* lengths,
               const void* offsets, void* out, int64_t n_seeds, int64_t n_vert,
               void* stream) {
  if (n_seeds <= 0 || n_vert <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t per_block = pack_walks_per_block(n_seeds);
  int device = 0, optin = 48 * 1024;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  const size_t staged = static_cast<size_t>(kPackStage) * sizeof(int32_t);
  const size_t with_row = staged + static_cast<size_t>(n_vert + 3) * sizeof(int32_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 64 bytes of static shared memory (run_end) stay beside the dynamic part.
  const cudaError_t e =
      with_row + 64 <= static_cast<size_t>(optin)
          ? launch_pack_walks<true>(next, seeds, lengths, offsets, out, n_seeds, n_vert,
                                    per_block, with_row, s)
          : launch_pack_walks<false>(next, seeds, lengths, offsets, out, n_seeds, n_vert,
                                     per_block, staged, s);
  return static_cast<int>(e);
}

}  // namespace mf

#define MF_STREAM_ENTRY_POINTS(SUFFIX, T)                                       \
  extern "C" int mf_next_hop_##SUFFIX(                                          \
      const void* unit, const void* v_world, const void* neighbors,             \
      const void* rules, const void* corners, const void* basis, void* next,    \
      int64_t n_frames, int64_t n_vert, int64_t width, void* stream) {          \
    return mf::next_hop<T>(unit, v_world, neighbors, rules, corners, basis,     \
                           next, n_frames, n_vert, width, stream);              \
  }

MF_STREAM_ENTRY_POINTS(f32, float)
MF_STREAM_ENTRY_POINTS(f64, double)

extern "C" int mf_trace_walks_i32(const void* next, void* lengths, int64_t n_frames,
                                  int64_t n_vert, int64_t max_steps, void* stream) {
  return mf::trace_walks(next, lengths, n_frames, n_vert, max_steps, stream);
}

extern "C" int mf_pack_walks_i32(const void* next, const void* seeds,
                                 const void* lengths, const void* offsets, void* out,
                                 int64_t n_seeds, int64_t n_vert, void* stream) {
  return mf::pack_walks(next, seeds, lengths, offsets, out, n_seeds, n_vert, stream);
}
