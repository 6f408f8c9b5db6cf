// FEM kernels: the matvec (K1), the block-Jacobi build (K2) and the frame
// factors with the right-hand side (K4). Layouts follow the JAX package:
//   x, y, f        (T, 2N)      DOF vectors, dof = vertex + N * alpha
//   dof            (M, 6)       int32 global DOF per local DOF l = corner*2+alpha
//   blocks2        (M, 6, 6)    a2 local blocks
//   g              (T, M, 3, 2) a1 factors (grad_M I . e_c^alpha)
//   gather_base    (N, C)       int32 vertex -> cell*6 + slot*2; padded
//                               entries (vertex_cells < 0) hold 6M and are
//                               skipped, so nothing past y_loc is read
//   K1's tiles     cell_ptr (K + 1), cells (L), gather (N, C) int32,
//                  cell_dof (6, L) int32, tile_blocks2 (21, L)
//                               (fem/assembly.py vertex_tiles): the cells
//                               of each tile of consecutive vertices,
//                               gather_base in tile-local cells (-1
//                               padded), and the cells' dof and a2 blocks
//                               (the 21 entries on and above the
//                               diagonal) local index first, in table
//                               order
//   K4's ownership own_ptr (K + 1), owned (M) int32 (fem/assembly.py
//                  cell_tiles): each cell is owned by the first tile that
//                  lists it; tile k's owned cells, as indices into its
//                  cells, ascending, are owned[own_ptr[k]:own_ptr[k+1]]
// The C entry points return the cudaError_t of the launches.
//
// K1 is bound by its bytes: g read once (14.1 MB in f32 at the bench
// shapes, 97 x 6050 triangles; 57.4 MB at 12.5k), x, y and the tables. Its
// first design wrote the (T, M, 6) local products to device memory in one
// launch and summed them per vertex in a second: 2 x 14.1 MB more at the
// bench shapes, 2 x 57.4 MB at 12.5k, where nothing fits in L2. This
// design makes one launch: a block owns a tile of consecutive vertices for
// a few frames, computes the local products of every cell incident to the
// tile (halo cells too: 22% more cells at the bench tiles, 44% at 12.5k)
// into shared memory, then sums each vertex's entries in gather_base's
// order. The local product is the same expression as before and the sums
// run in the same order, so the output is the first design's, bit for
// bit. A cell's dof and a2 block are read once for all the block's frames
// and held in registers, from the tile tables' copies, stored local index
// first in table order so that a warp's lanes (consecutive cells) read
// consecutive addresses, and only the a2 block's 21 distinct entries.
// Phase 1 waits on its loads (g from device memory, x and the tables from
// L2): on the H100 it is latency-bound, so the launch bounds keep three
// blocks an SM in float32. Tried on the card and slower: dof and the a2
// rows read in their (M, 6) / (M, 6, 6) layouts (a warp's lanes 24 and 144
// bytes apart); each frame's g rows and x values staged in shared memory
// first (the loads then wait behind a barrier); one thread per vertex
// recomputing its slot's two outputs in each incident cell; 8 frames a
// block (shared memory then limits the blocks an SM); tiles of 128 or 512
// vertices with 256 threads.
#include "common.cuh"

namespace mf {

// Index of entry (l, j) of a symmetric 6x6 block among its 21 entries on
// and above the diagonal, row by row.
__host__ __device__ constexpr int sym_index(int l, int j) {
  return l <= j ? l * 6 - l * (l - 1) / 2 + (j - l) : sym_index(j, l);
}

// b[k] = upper[sym_index(k / 6, k % 6)] for k = K..35, each index fixed at
// compile time, so both arrays stay in registers.
template <int K = 0, typename T>
__device__ __forceinline__ void expand_symmetric(const T* upper, T* b) {
  if constexpr (K < 36) {
    constexpr int i = sym_index(K / 6, K % 6);
    b[K] = upper[i];
    expand_symmetric<K + 1>(upper, b);
  }
}

// K1's local product of one triangle (fem/operator.py:56-67):
// y[l] = lambda * B2 x_loc + g * (A/12) * (s_c + sum_c s_c), s_c = <g_c, x_c>,
// term for term the expression of the first design's phase 1.
template <typename T>
__device__ __forceinline__ void local_product(const T* xl, const T* gl,
                                              const T* b, T ws, T lambda,
                                              T* y) {
  T s[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s[c] = gl[2 * c] * xl[2 * c] + gl[2 * c + 1] * xl[2 * c + 1];
  }
  const T stot = s[0] + s[1] + s[2];
#pragma unroll
  for (int l = 0; l < 6; ++l) {
    T y2 = T(0);
#pragma unroll
    for (int j = 0; j < 6; ++j) y2 += b[l * 6 + j] * xl[j];
    const T w = ws * (s[l >> 1] + stot);
    y[l] = lambda * y2 + gl[l] * w;
  }
}

// K1: block (k, j) owns tile k's vertices for frames j*F .. j*F + F - 1
// (and every gridDim.y-th group after). Phase 1: one thread per tile cell
// loads the cell's dof and a2 block once (its 21 distinct entries: a2 is
// symmetric, exactly, as assembly.a2_blocks computes it), then for each
// frame gathers x and g and writes the six local outputs to shared memory
// (y_loc[frame][cell][6]). Phase 2: one thread per tile vertex sums its
// entries in its gather row's order and writes y, or f - y. Launch bounds
// of 3 blocks an SM (float32) or 2 (float64) keep enough warps in flight.
template <typename T, int F>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 3 : 2)
    fem_tile_kernel(const T* __restrict__ x, const int32_t* __restrict__ cell_dof,
                    const T* __restrict__ tile_blocks2, const T* __restrict__ g,
                    const T* __restrict__ w_scale, T lambda,
                    const int32_t* __restrict__ cell_ptr,
                    const int32_t* __restrict__ cells,
                    const int32_t* __restrict__ gather,
                    const T* __restrict__ f, T* __restrict__ out,
                    int64_t n_frames, int64_t n_tri, int64_t n_vert,
                    int64_t n_cols, int64_t tile_size, int64_t n_listed) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* y_loc = reinterpret_cast<T*>(smem_raw);
  const int64_t c0 = cell_ptr[blockIdx.x];
  const int n_cells = static_cast<int>(cell_ptr[blockIdx.x + 1] - c0);
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * tile_size;
  const int64_t left = n_vert - v0;
  const int n_own = static_cast<int>(left < tile_size ? left : tile_size);
  const int64_t n_dof = 2 * n_vert;
  const int64_t frame_stride = static_cast<int64_t>(n_cells) * 6;
  for (int64_t t0 = static_cast<int64_t>(blockIdx.y) * F; t0 < n_frames;
       t0 += static_cast<int64_t>(gridDim.y) * F) {
    const int nf = n_frames - t0 < F ? static_cast<int>(n_frames - t0) : F;
    for (int c = threadIdx.x; c < n_cells; c += kThreads) {
      const int64_t i = c0 + c;
      const int64_t m = __ldg(cells + i);
      int32_t d[6];
      T upper[21], b[36];
#pragma unroll
      for (int l = 0; l < 6; ++l) d[l] = __ldg(cell_dof + l * n_listed + i);
#pragma unroll
      for (int k = 0; k < 21; ++k) upper[k] = __ldg(tile_blocks2 + k * n_listed + i);
      expand_symmetric(upper, b);
      const T ws = __ldg(w_scale + m);
#pragma unroll
      for (int u = 0; u < F; ++u) {
        if (u < nf) {
          const int64_t t = t0 + u;
          const T* xt = x + t * n_dof;
          const T* gt = g + (t * n_tri + m) * 6;
          T xl[6], gl[6];
#pragma unroll
          for (int l = 0; l < 6; ++l) gl[l] = __ldg(gt + l);
#pragma unroll
          for (int l = 0; l < 6; ++l) xl[l] = __ldg(xt + d[l]);
          local_product(xl, gl, b, ws, lambda, y_loc + u * frame_stride + c * 6);
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_own; i += kThreads) {
      const int64_t v = v0 + i;
      const int32_t* row = gather + v * n_cols;
      T a[F], e[F];
#pragma unroll
      for (int u = 0; u < F; ++u) a[u] = e[u] = T(0);
      for (int64_t c = 0; c < n_cols; ++c) {
        const int32_t k = __ldg(row + c);
        if (k < 0) continue;  // padded entry
#pragma unroll
        for (int u = 0; u < F; ++u) {
          a[u] += y_loc[u * frame_stride + k];
          e[u] += y_loc[u * frame_stride + k + 1];
        }
      }
#pragma unroll
      for (int u = 0; u < F; ++u) {
        if (u < nf) {
          const int64_t o = (t0 + u) * n_dof + v;
          if (f != nullptr) {
            out[o] = f[o] - a[u];
            out[o + n_vert] = f[o + n_vert] - e[u];
          } else {
            out[o] = a[u];
            out[o + n_vert] = e[u];
          }
        }
      }
    }
    __syncthreads();  // the next frames' phase 1 overwrites y_loc
  }
}

// K2: the inverted 2x2 diagonal blocks of A = a1_k + lambda a2
// (fem/assembly.py:134-178, fem/operator.py:119-129). A (frame, vertex)
// block sums lambda * reg + g g^T * A/6 over the vertex's incident corners
// in gather_base's order, then takes the closed-form inverse; a singular
// block becomes the identity.
//
// Bound by its bytes: g (14.1 MB in float32 at the bench shapes, 57.4 MB
// at 12.5k, past the 50 MB L2) read once through the vertex table, and the
// blocks written once. The first design gave each thread one (frame,
// vertex) and redid the frame-independent work for each of the 97 frames:
// the table entry, its corner and cell, the area's quotient by 6, the four
// reg entries and their products with lambda. Here a thread takes a vertex
// and kJacobiFrames consecutive frames: it forms each table entry's
// corner, A/6 and lambda * reg once for them, issues their g loads before
// their sums, and writes each block as one 16-byte store in float32 (two
// in float64). Every value is the first design's expression with the
// contraction nvcc gave it there (its SASS), written out:
// d += fma(g_a g_b, A/6, lambda * reg), det = fma(d3, d0, -(d2 d1)), and
// four quotients by det, so the blocks are the first design's bit for
// bit. On the H100, 4 frames in 128-thread blocks beat 1, 2 and 8 frames,
// blocks of 64 and 256, capped registers (spills), two entries at a time
// and pair loads of g and reg.
constexpr int kJacobiThreads = 128;
constexpr int kJacobiFrames = 4;

template <typename T>
__global__ void __launch_bounds__(kJacobiThreads) jacobi_kernel(
    const T* __restrict__ g, const T* __restrict__ reg, const T* __restrict__ areas,
    T lambda, const int32_t* __restrict__ gather_base, T* __restrict__ dinv,
    int64_t n_frames, int64_t n_tri, int64_t n_vert, int64_t n_cols) {
  constexpr int F = kJacobiFrames;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kJacobiThreads + threadIdx.x;
  if (v >= n_vert) return;
  const int64_t n_local = 6 * n_tri;  // a frame of g; padded entries hold it
  const int32_t* row = gather_base + v * n_cols;
  for (int64_t t0 = static_cast<int64_t>(blockIdx.y) * F; t0 < n_frames;
       t0 += static_cast<int64_t>(gridDim.y) * F) {
    const int64_t left = n_frames - t0;
    const int nf = left < F ? static_cast<int>(left) : F;
    const T* gt = g + t0 * n_local;
    T d[F][4];
#pragma unroll
    for (int f = 0; f < F; ++f) d[f][0] = d[f][1] = d[f][2] = d[f][3] = T(0);
    for (int64_t c = 0; c < n_cols; ++c) {
      const int32_t base = row[c];
      if (base < 0 || base >= n_local) continue;  // padded entry
      const int32_t corner = base >> 1;            // cell * 3 + slot
      const T a6 = areas[corner / 3] / T(6);
      const T* rc = reg + static_cast<int64_t>(corner) * 4;
      T lr[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) lr[k] = rn_mul(lambda, rc[k]);
      T g0[F], g1[F];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        if (f < nf) {
          const T* gc = gt + f * n_local + 2 * static_cast<int64_t>(corner);
          g0[f] = gc[0];
          g1[f] = gc[1];
        }
      }
#pragma unroll
      for (int f = 0; f < F; ++f) {
        if (f < nf) {
          const T p01 = rn_mul(g0[f], g1[f]);
          d[f][0] = rn_add(d[f][0], rn_fma(rn_mul(g0[f], g0[f]), a6, lr[0]));
          d[f][1] = rn_add(d[f][1], rn_fma(p01, a6, lr[1]));
          d[f][2] = rn_add(d[f][2], rn_fma(p01, a6, lr[2]));
          d[f][3] = rn_add(d[f][3], rn_fma(rn_mul(g1[f], g1[f]), a6, lr[3]));
        }
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      if (f < nf) {
        const T det = rn_fma(d[f][3], d[f][0], -rn_mul(d[f][2], d[f][1]));
        T o[4] = {T(1), T(0), T(0), T(1)};
        if (det > T(0) || det < T(0)) {
          o[0] = rn_div(d[f][3], det);
          o[1] = rn_div(-d[f][1], det);
          o[2] = rn_div(-d[f][2], det);
          o[3] = rn_div(d[f][0], det);
        }
        store4(dinv + ((t0 + f) * n_vert + v) * 4, o);
      }
    }
  }
}

// K4: the a1 factors g[t, m, c, a] = (sum_k I_t[v_k] grad_w[m, k]) .
// e_{v_c}^a and the RHS f[t] = sum over each vertex's (cell, slot) entries
// of the local RHS g * (dI_c + sum dI) * A/12, with dI = (I_next[t + 1] -
// I[t]) / (times[t + 1] - times[t]) (fem/assembly.py:61-71, 99-106;
// solve/api.py:83-86).
// Bound on this card: memory traffic, g written (114.7 MB in f64 at 12.5k
// vertices, 28.2 MB at the bench shapes), f written and the movie read.
// The first design wrote g and the local RHS (as large as g) in one launch,
// one thread per (frame, triangle), and read the local RHS back in a
// second launch to sum it per vertex. This design makes one launch with K1's
// tiles: block (k, j) owns tile k's vertices for frames j*F .. j*F + F - 1.
// Phase 1: one thread per tile cell (halo cells too) loads the cell's
// corners, grad_w row, corner bases and area once for the block's frames,
// then for each frame writes the cell's six g values and three corner
// scales (dI_c + sum dI) * A/12 to shared memory. Phase 2: one thread per
// tile vertex sums its entries g * scale in its gather row's order, the
// first design's order, and writes f. Phase 3: the block writes g of the
// cells it owns (every cell has one owner) from shared memory, consecutive
// threads on consecutive elements. Each value keeps the first design's
// expression, with its fused multiply-adds written out as nvcc formed them
// there, so g and f are that design's bit for bit. F = 2 in both types:
// on the H100 F = 1 (the geometry read again each frame) and F = 4 (one
// block an SM) were slower.
// a0 b0 + a1 b1 + a2 b2 as nvcc contracted it in the first design: the
// first product fused into the first sum, the third into the second.
template <typename T>
__device__ __forceinline__ T fma3(T a0, T b0, T a1, T b1, T a2, T b2) {
  return rn_fma(a2, b2, rn_fma(a0, b0, rn_mul(a1, b1)));
}

template <typename T, int F>
__global__ void __launch_bounds__(kThreads, 2)
    frame_factors_rhs_kernel(
        const T* __restrict__ pot, const T* __restrict__ nxt,
        const T* __restrict__ times, const int32_t* __restrict__ tris,
        const T* __restrict__ grad_w, const T* __restrict__ basis,
        const T* __restrict__ areas, const int32_t* __restrict__ cell_ptr,
        const int32_t* __restrict__ cells, const int32_t* __restrict__ gather,
        const int32_t* __restrict__ own_ptr, const int32_t* __restrict__ owned,
        T* __restrict__ g, T* __restrict__ f, int64_t n_frames, int64_t n_tri,
        int64_t n_vert, int64_t n_cols, int64_t tile_size, int64_t max_cells) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* g_s = reinterpret_cast<T*>(smem_raw);   // [F][max_cells][6]
  T* sc_s = g_s + F * max_cells * 6;         // [F][max_cells][3]
  const int64_t c0 = cell_ptr[blockIdx.x];
  const int n_cells = static_cast<int>(cell_ptr[blockIdx.x + 1] - c0);
  const int64_t o0 = own_ptr[blockIdx.x];
  const int n_owned = static_cast<int>(own_ptr[blockIdx.x + 1] - o0);
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * tile_size;
  const int64_t left = n_vert - v0;
  const int n_own = static_cast<int>(left < tile_size ? left : tile_size);
  for (int64_t t0 = static_cast<int64_t>(blockIdx.y) * F; t0 < n_frames;
       t0 += static_cast<int64_t>(gridDim.y) * F) {
    const int nf = n_frames - t0 < F ? static_cast<int>(n_frames - t0) : F;
    for (int c = threadIdx.x; c < n_cells; c += kThreads) {
      const int64_t m = __ldg(cells + c0 + c);
      int32_t v[3];
      T gw[9], e[18];
#pragma unroll
      for (int k = 0; k < 3; ++k) v[k] = __ldg(tris + m * 3 + k);
#pragma unroll
      for (int k = 0; k < 9; ++k) gw[k] = __ldg(grad_w + m * 9 + k);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int d = 0; d < 6; ++d) e[k * 6 + d] = __ldg(basis + static_cast<int64_t>(v[k]) * 6 + d);
      }
      const T w12 = __ldg(areas + m) / T(12);
#pragma unroll
      for (int u = 0; u < F; ++u) {
        if (u < nf) {
          const int64_t t = t0 + u;
          const T* pt = pot + t * n_vert;
          const T* qt = nxt + (t + 1) * n_vert;
          const T step = __ldg(times + t + 1) - __ldg(times + t);
          T val[3], di[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            val[k] = __ldg(pt + v[k]);
            di[k] = (__ldg(qt + v[k]) - val[k]) / step;
          }
          T gm[3];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            gm[d] = fma3(val[0], gw[d], val[1], gw[3 + d], val[2], gw[6 + d]);
          }
          const T s = di[0] + di[1] + di[2];
          T* gc = g_s + (static_cast<int64_t>(u) * max_cells + c) * 6;
          T* sc = sc_s + (static_cast<int64_t>(u) * max_cells + c) * 3;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            sc[k] = (di[k] + s) * w12;
#pragma unroll
            for (int a = 0; a < 2; ++a) {
              const T* ek = e + k * 6 + a * 3;
              gc[k * 2 + a] = fma3(gm[0], ek[0], gm[1], ek[1], gm[2], ek[2]);
            }
          }
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_own; i += kThreads) {
      const int64_t v = v0 + i;
      const int32_t* row = gather + v * n_cols;
      T a[F], b[F];
#pragma unroll
      for (int u = 0; u < F; ++u) a[u] = b[u] = T(0);
      for (int64_t c = 0; c < n_cols; ++c) {
        const int32_t k = __ldg(row + c);
        if (k < 0) continue;  // padded entry
#pragma unroll
        for (int u = 0; u < F; ++u) {
          const T* gu = g_s + static_cast<int64_t>(u) * max_cells * 6;
          const T scale = sc_s[static_cast<int64_t>(u) * max_cells * 3 + (k >> 1)];
          a[u] += rn_mul(gu[k], scale);  // the first design's rounded local RHS
          b[u] += rn_mul(gu[k + 1], scale);
        }
      }
#pragma unroll
      for (int u = 0; u < F; ++u) {
        if (u < nf) {
          const int64_t o = (t0 + u) * 2 * n_vert + v;
          f[o] = a[u];
          f[o + n_vert] = b[u];
        }
      }
    }
    const int per_frame = n_owned * 6;
    for (int j = threadIdx.x; j < nf * per_frame; j += kThreads) {
      const int u = j / per_frame;
      const int r = j - u * per_frame;
      const int q = r / 6;
      const int l = r - q * 6;
      const int32_t local = __ldg(owned + o0 + q);
      const int64_t m = __ldg(cells + c0 + local);
      g[((t0 + u) * n_tri + m) * 6 + l] = g_s[(static_cast<int64_t>(u) * max_cells + local) * 6 + l];
    }
    __syncthreads();  // the next frames' phase 1 overwrites the tables
  }
}

template <typename T, int F>
cudaError_t launch_fem_tiles(const void* x, const void* cell_dof,
                             const void* tile_blocks2, const void* g,
                             const void* w_scale, double lambda,
                             const void* cell_ptr, const void* cells,
                             const void* gather, const void* f, void* out,
                             int64_t n_frames, int64_t n_tri, int64_t n_vert,
                             int64_t n_cols, int64_t tile_size, int64_t n_tiles,
                             int64_t max_cells, int64_t n_listed, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(F) * max_cells * 6 * sizeof(T);
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t e = cudaFuncSetAttribute(
        fem_tile_kernel<T, F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned int>(n_tiles),
                  frame_blocks((n_frames + F - 1) / F));
  fem_tile_kernel<T, F><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(cell_dof),
      static_cast<const T*>(tile_blocks2), static_cast<const T*>(g),
      static_cast<const T*>(w_scale), static_cast<T>(lambda),
      static_cast<const int32_t*>(cell_ptr), static_cast<const int32_t*>(cells),
      static_cast<const int32_t*>(gather), static_cast<const T*>(f),
      static_cast<T*>(out), n_frames, n_tri, n_vert, n_cols, tile_size, n_listed);
  return cudaGetLastError();
}

template <typename T>
int fem_matvec(const void* x, const void* cell_dof, const void* tile_blocks2,
               const void* g, const void* w_scale, double lambda,
               const void* cell_ptr, const void* cells, const void* gather,
               const void* f, void* out, int64_t n_frames, int64_t n_tri,
               int64_t n_vert, int64_t n_cols, int64_t tile_size,
               int64_t n_tiles, int64_t max_cells, int64_t n_listed,
               int64_t frames_per_block, void* stream) {
  if (n_frames <= 0 || n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
#define MF_FEM_TILES(F)                                                        \
  e = launch_fem_tiles<T, F>(x, cell_dof, tile_blocks2, g, w_scale, lambda,    \
                             cell_ptr, cells, gather, f, out, n_frames, n_tri, \
                             n_vert, n_cols, tile_size, n_tiles, max_cells,    \
                             n_listed, s)
  switch (frames_per_block) {
    case 1: MF_FEM_TILES(1); break;
    case 2: MF_FEM_TILES(2); break;
    case 4: MF_FEM_TILES(4); break;
    default: break;
  }
#undef MF_FEM_TILES
  return static_cast<int>(e);
}

template <typename T>
int jacobi_blocks(const void* g, const void* reg, const void* areas, double lambda,
                  const void* gather_base, void* dinv, int64_t n_frames, int64_t n_tri,
                  int64_t n_vert, int64_t n_cols, void* stream) {
  if (n_frames > 0 && n_vert > 0) {
    const dim3 grid(static_cast<unsigned int>((n_vert + kJacobiThreads - 1) / kJacobiThreads),
                    frame_blocks((n_frames + kJacobiFrames - 1) / kJacobiFrames));
    jacobi_kernel<T><<<grid, kJacobiThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(g), static_cast<const T*>(reg), static_cast<const T*>(areas),
        static_cast<T>(lambda), static_cast<const int32_t*>(gather_base),
        static_cast<T*>(dinv), n_frames, n_tri, n_vert, n_cols);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int F>
cudaError_t launch_frame_factors_rhs(
    const void* pot, const void* nxt, const void* times, const void* tris,
    const void* grad_w, const void* basis, const void* areas, const void* cell_ptr,
    const void* cells, const void* gather, const void* own_ptr, const void* owned,
    void* g, void* f, int64_t n_frames, int64_t n_tri, int64_t n_vert, int64_t n_cols,
    int64_t tile_size, int64_t n_tiles, int64_t max_cells, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(F) * max_cells * 9 * sizeof(T);
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t e = cudaFuncSetAttribute(
        frame_factors_rhs_kernel<T, F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned int>(n_tiles),
                  frame_blocks((n_frames + F - 1) / F));
  frame_factors_rhs_kernel<T, F><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(pot), static_cast<const T*>(nxt),
      static_cast<const T*>(times), static_cast<const int32_t*>(tris),
      static_cast<const T*>(grad_w), static_cast<const T*>(basis),
      static_cast<const T*>(areas), static_cast<const int32_t*>(cell_ptr),
      static_cast<const int32_t*>(cells), static_cast<const int32_t*>(gather),
      static_cast<const int32_t*>(own_ptr), static_cast<const int32_t*>(owned),
      static_cast<T*>(g), static_cast<T*>(f), n_frames, n_tri, n_vert, n_cols,
      tile_size, max_cells);
  return cudaGetLastError();
}

template <typename T>
int frame_factors_rhs(const void* pot, const void* nxt, const void* times,
                      const void* tris, const void* grad_w, const void* basis,
                      const void* areas, const void* cell_ptr, const void* cells,
                      const void* gather, const void* own_ptr, const void* owned,
                      void* g, void* f, int64_t n_frames, int64_t n_tri,
                      int64_t n_vert, int64_t n_cols, int64_t tile_size,
                      int64_t n_tiles, int64_t max_cells, int64_t frames_per_block,
                      void* stream) {
  if (n_frames <= 0 || n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
#define MF_FRAME_FACTORS(F)                                                        \
  e = launch_frame_factors_rhs<T, F>(pot, nxt, times, tris, grad_w, basis, areas,  \
                                     cell_ptr, cells, gather, own_ptr, owned, g, f, \
                                     n_frames, n_tri, n_vert, n_cols, tile_size,   \
                                     n_tiles, max_cells, s)
  switch (frames_per_block) {
    case 1: MF_FRAME_FACTORS(1); break;
    case 2: MF_FRAME_FACTORS(2); break;
    default: break;
  }
#undef MF_FRAME_FACTORS
  return static_cast<int>(e);
}

}  // namespace mf

#define MF_FEM_ENTRY_POINTS(SUFFIX, T)                                        \
  extern "C" int mf_fem_matvec_##SUFFIX(                                      \
      const void* x, const void* cell_dof, const void* tile_blocks2,          \
      const void* g, const void* w_scale, double lambda, const void* cell_ptr, \
      const void* cells, const void* gather, const void* f, void* out,        \
      int64_t n_frames, int64_t n_tri, int64_t n_vert, int64_t n_cols,        \
      int64_t tile_size, int64_t n_tiles, int64_t max_cells,                  \
      int64_t n_listed, int64_t frames_per_block, void* stream) {             \
    return mf::fem_matvec<T>(x, cell_dof, tile_blocks2, g, w_scale, lambda,   \
                             cell_ptr, cells, gather, f, out, n_frames,       \
                             n_tri, n_vert, n_cols, tile_size, n_tiles,       \
                             max_cells, n_listed, frames_per_block, stream);  \
  }                                                                           \
  extern "C" int mf_jacobi_blocks_##SUFFIX(                                   \
      const void* g, const void* reg, const void* areas, double lambda,       \
      const void* gather_base, void* dinv, int64_t n_frames, int64_t n_tri,   \
      int64_t n_vert, int64_t n_cols, void* stream) {                         \
    return mf::jacobi_blocks<T>(g, reg, areas, lambda, gather_base, dinv,     \
                                n_frames, n_tri, n_vert, n_cols, stream);     \
  }                                                                           \
  extern "C" int mf_frame_factors_rhs_##SUFFIX(                               \
      const void* pot, const void* nxt, const void* times, const void* tris,  \
      const void* grad_w, const void* basis, const void* areas,               \
      const void* cell_ptr, const void* cells, const void* gather,            \
      const void* own_ptr, const void* owned, void* g, void* f,               \
      int64_t n_frames, int64_t n_tri, int64_t n_vert, int64_t n_cols,        \
      int64_t tile_size, int64_t n_tiles, int64_t max_cells,                  \
      int64_t frames_per_block, void* stream) {                               \
    return mf::frame_factors_rhs<T>(pot, nxt, times, tris, grad_w, basis,    \
                                    areas, cell_ptr, cells, gather, own_ptr,  \
                                    owned, g, f, n_frames, n_tri, n_vert,     \
                                    n_cols, tile_size, n_tiles, max_cells,    \
                                    frames_per_block, stream);                \
  }

MF_FEM_ENTRY_POINTS(f32, float)
MF_FEM_ENTRY_POINTS(f64, double)

extern "C" const char* mf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
