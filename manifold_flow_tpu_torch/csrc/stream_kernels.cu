// Streamline kernels of the S6 stage: the per-frame next-hop graph (K13)
// and the walks over it (K14: walk lengths, and the packing of walks into
// one flat id buffer). Layouts follow the JAX package:
//   unit        (N, D, 3)   projected unit edge vectors to the 1-ring
//                           (frame-independent, built once per mesh)
//   neighbors   (N, D)      1-ring vertex ids, -1 padded
//   vertex_cells(N, C)      incident cell ids in ascending order, -1 padded
//   v_world     (T, N, 3)   world velocity vectors
//   next        (T, N)      int32 frame-local next vertex; a halting vertex
//                           points to itself
// Every decision (the argmax over the 1-ring, dmax > 0, the boundary
// triangle test) is computed with the explicitly rounded operations of
// common.cuh, in the JAX expression order, so `next` equals the plain torch
// version's. The C entry points return the cudaError_t of the launches.
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
// Bound on this card: memory traffic. At the bench shapes (97 frames, 3136
// vertices, f64) a call reads v_world once (7.3 MB) and the unit table
// (under 1 MB, from L2 after the first frame) and writes next (1.2 MB):
// about 2.5 us at 3.35 TB/s. Design: one thread per (frame, vertex); the
// unit table is computed once per mesh outside the kernel, so a thread does
// D dot products; only the ~7% boundary rows that would advance run the
// shared-cell scan and the triangle test.

template <typename T>
__device__ __forceinline__ T cross2(T ax, T ay, T bx, T by) {
  return rn_sub(rn_mul(ax, by), rn_mul(ay, bx));
}

// (u, v) of `rel` on (e1, e2) after projecting it onto their plane
// (geometry/tangent.py position_diff_on_basis of rel = b - a).
template <typename T>
__device__ __forceinline__ void plane_coords(const T* rel, const T* e1, const T* e2,
                                             const T* n, T nn, T* out) {
  const T s = nn > T(0) ? rn_div(dot3(rel, n), nn) : T(0);
  T proj[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) proj[d] = rn_sub(rel[d], rn_mul(s, n[d]));
  out[0] = dot3(proj, e1);
  out[1] = dot3(proj, e2);
}

// The reference's index arithmetic (ops/streamline.py:88 _scalar_posdiff):
// proj = s - s (n * n) / |n|^2 elementwise for a scalar s.
template <typename T>
__device__ __forceinline__ void scalar_posdiff(T s, const T* e1, const T* e2,
                                               const T* n, T nn, T* out) {
  T proj[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) proj[d] = rn_sub(s, rn_div(rn_mul(s, rn_mul(n[d], n[d])), nn));
  out[0] = dot3(proj, e1);
  out[1] = dot3(proj, e2);
}

// ops/streamline.py:98 _boundary_triangle_test for vertex `a` moving to
// `cand` across triangle `cell`.
template <typename T>
__device__ bool triangle_test(const T* __restrict__ points, const int32_t* __restrict__ tris,
                              int32_t a, int32_t cand, int32_t cell, const T* e1,
                              const T* e2, const T* vel, bool quirks) {
  const int32_t t0 = tris[3 * static_cast<int64_t>(cell)];
  const int32_t t1 = tris[3 * static_cast<int64_t>(cell) + 1];
  const int32_t t2 = tris[3 * static_cast<int64_t>(cell) + 2];
  const int32_t b = t0 == a ? t1 : (t1 == a ? t0 : t1);
  const int32_t c = t2 == a ? t0 : t2;
  T n[3];
  cross3(e1, e2, n);
  const T nn = dot3(n, n);
  T p1[2], p2[2];
  if (quirks) {
    scalar_posdiff(static_cast<T>(b - a), e1, e2, n, nn, p1);
    scalar_posdiff(static_cast<T>(a - c), e1, e2, n, nn, p2);
  } else {
    const T* pa = points + 3 * static_cast<int64_t>(a);
    const T* pb = points + 3 * static_cast<int64_t>(b);
    const T* pc = points + 3 * static_cast<int64_t>(c);
    T rb[3], rc[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      rb[d] = rn_sub(pb[d], pa[d]);
      rc[d] = rn_sub(pc[d], pa[d]);
    }
    plane_coords(rb, e1, e2, n, nn, p1);
    plane_coords(rc, e1, e2, n, nn, p2);
  }
  const T orient = cross2(p1[0], p1[1], p2[0], p2[1]);
  const bool ccw = orient >= T(0);
  const T bx = ccw ? p1[0] : p2[0], by = ccw ? p1[1] : p2[1];
  const T cx = ccw ? p2[0] : p1[0], cy = ccw ? p2[1] : p1[1];
  const T vx = rn_div(dot3(vel, e1), dot3(e1, e1));
  const T vy = rn_div(dot3(vel, e2), dot3(e2, e2));
  const bool inside = cross2(bx, by, vx, vy) > T(0) &&
                      cross2(rn_sub(cx, bx), rn_sub(cy, by), rn_sub(vx, bx), rn_sub(vy, by)) > T(0) &&
                      cross2(-cx, -cy, rn_sub(vx, cx), rn_sub(vy, cy)) > T(0);
  return inside && orient != T(0);
}

template <typename T>
__global__ void next_hop_kernel(
    const T* __restrict__ unit, const T* __restrict__ v_world,
    const int32_t* __restrict__ neighbors, const int32_t* __restrict__ cell_count,
    const int32_t* __restrict__ vertex_cells, const int32_t* __restrict__ tris,
    const T* __restrict__ points, const T* __restrict__ basis,
    int32_t* __restrict__ next, int64_t n_frames, int64_t n_vert, int64_t width,
    int64_t cells, bool quirks) {
  const int64_t v = global_index();
  if (v >= n_vert) return;
  for (int64_t t = blockIdx.y; t < n_frames; t += gridDim.y) {
    const T* vel = v_world + (t * n_vert + v) * 3;
    const T vv[3] = {vel[0], vel[1], vel[2]};
    // argmax in torch.argmax's order: a NaN is the largest, ties to the
    // first index; masked entries are -inf, so an all-masked row gives 0.
    T best = -INFINITY;
    int64_t best_d = 0;
    for (int64_t d = 0; d < width; ++d) {
      const int32_t nb = neighbors[v * width + d];
      const T val = nb != -1 ? dot3(unit + (v * width + d) * 3, vv) : T(-INFINITY);
      if (best != best) break;
      if (val != val || val > best) {
        best = val;
        best_d = d;
      }
    }
    const int32_t nb_best = neighbors[v * width + best_d];
    const int32_t cand = nb_best != -1 ? nb_best : 0;
    bool advance = best > T(0);
    if (advance && cell_count[v] < 6) {
      // Cells shared with the candidate: their count, and the first of the
      // vertex's own cells (ascending) that the candidate also has.
      int count = 0;
      int32_t first = -1;
      for (int64_t i = 0; i < cells; ++i) {
        const int32_t ca = vertex_cells[v * cells + i];
        if (ca == -1) continue;
        bool match = false;
        for (int64_t j = 0; j < cells; ++j) {
          const int32_t cb = vertex_cells[static_cast<int64_t>(cand) * cells + j];
          match = match || (cb != -1 && cb == ca);
        }
        if (match) {
          if (first < 0) first = ca;
          ++count;
        }
      }
      advance = count >= 2 ||
                (first >= 0 && triangle_test(points, tris, static_cast<int32_t>(v), cand,
                                             first, basis + v * 6, basis + v * 6 + 3, vv,
                                             quirks));
    }
    next[t * n_vert + v] = advance ? cand : static_cast<int32_t>(v);
  }
}

template <typename T>
int next_hop(const void* unit, const void* v_world, const void* neighbors,
             const void* cell_count, const void* vertex_cells, const void* tris,
             const void* points, const void* basis, void* next, int64_t n_frames,
             int64_t n_vert, int64_t width, int64_t cells, int64_t quirks,
             void* stream) {
  if (n_frames > 0 && n_vert > 0) {
    const dim3 grid(blocks_for(n_vert), frame_blocks(n_frames));
    next_hop_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(unit), static_cast<const T*>(v_world),
        static_cast<const int32_t*>(neighbors), static_cast<const int32_t*>(cell_count),
        static_cast<const int32_t*>(vertex_cells), static_cast<const int32_t*>(tris),
        static_cast<const T*>(points), static_cast<const T*>(basis),
        static_cast<int32_t*>(next), n_frames, n_vert, width, cells, quirks != 0);
  }
  return static_cast<int>(cudaGetLastError());
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
      const void* cell_count, const void* vertex_cells, const void* tris,       \
      const void* points, const void* basis, void* next, int64_t n_frames,      \
      int64_t n_vert, int64_t width, int64_t cells, int64_t quirks,             \
      void* stream) {                                                           \
    return mf::next_hop<T>(unit, v_world, neighbors, cell_count, vertex_cells,  \
                           tris, points, basis, next, n_frames, n_vert, width,  \
                           cells, quirks, stream);                              \
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
