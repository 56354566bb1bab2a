// Fused sLSTM recurrence for Hopper (sm_90a): the kernels and their
// launchers, shared by slstm_scan.cu (serving: the C entries slstm_scan and
// slstm_scan_max_clusters) and slstm_scan_train.cu (training: slstm_scan_save,
// slstm_scan_bwd, slstm_scan_bwd_max_clusters), which nvcc compiles in
// parallel.
//
//   slstm_cluster_kernel<T, SLOTS, UL, SAVE>  replaces src/repro/kernels/
//                 slstm_scan.py::_kernel (entry slstm_scan_pallas): the whole
//                 (B, S) scan of
//                     z = tanh(pre_z + h R_z)      i = exp(min(pre_i + h R_i, 5))
//                     f = sigmoid(pre_f + h R_f)   o = sigmoid(pre_o + h R_o)
//                     c' = f c + i z    n' = f n + i    h' = o c' / max(n', 1)
//                 in one launch, returning every h and the final (c, n, h).
//                 SAVE (training) also writes what the backward reads.
//   slstm_scan_bwd_kernel<T, SLOTS>  the backward of that scan (the
//                 reference's autodiff through the jax.lax.scan of
//                 src/repro/models/xlstm.py slstm_block): its note is below.
//
// Shapes: pre (B, S, 4, H, dh) and h_all (B, S, H, dh) in T; R_z, R_i, R_f,
// R_o (H, dh, dh) in T, R[h, d, e] taking input d to output e; c0, n0, h0 and
// c1, n1, h1 (B, H, dh) float32.  T is float or __nv_bfloat16; every product
// and sum is float32, and h_all is rounded once to T (round to nearest even),
// where the reference rounds hs.
//
// What bounds it on this card.  Over a call the function moves the four
// recurrent matrices once (8 MB in bf16 at H = 4, dh = 512) and does
// 2 B S 4 H dh^2 float32 operations: bytes at decode (S = 1), float32
// operations in prefill.  The S steps are strictly sequential, which the
// bound does not see: each step needs the whole h of the step before.
//
// Design.  A head's output columns are split over the CTAs of a thread-block
// cluster (grid: column blocks x heads x batch groups; a cluster is the
// column blocks of one (head, batch group)).  A CTA owns `cols` columns of all
// four gates (32 at dh = 512 in a cluster of 16) for up to SLOTS batch rows,
// so each element of its R slice is read once a step for all of its rows.
//  - The slice is cut into 16-byte units (8 bf16 or 4 float columns of one
//    gate and one input row d).  A warp slot takes UL adjacent units of one
//    gate (UL = 4 where the gate's units allow: 64 contiguous bytes of a bf16
//    row) and a quarter (1 / UL) of the rows: lane (dl, ul) sums the rows
//    d = wq 32/UL + dl + 32 k of unit ul for every column and batch row in
//    float32 registers.  A butterfly over the row lanes (shuffles that halve
//    the values each level) leaves each sum in one lane, which writes it to
//    shared memory; the gate step adds the UL slots' partials.
//  - Where S > 1 the CTA stages the first `resident` rows of its slice in
//    shared memory (cp.async, once a launch; 128 KB at bf16 dh = 512, all of
//    it), each lane the rows it reads, laid out [group][d][ul] so that a warp
//    reads 512 contiguous bytes.  Rows past `resident` (float32 at dh = 512,
//    dh up to 2048) are read from global memory every step.  At S = 1
//    nothing is staged: each element is used once and is read straight from
//    global memory, eight units in flight a lane, UL x 16 contiguous bytes of
//    a row each.
//  - h of the step before sits in every CTA as float32 [d][SLOTS], in two
//    buffers used in turn.  After the gates of step t each CTA writes its
//    cols x SLOTS block of h_t into the other buffer of every CTA of its
//    cluster (distributed shared memory, 16-byte stores) and the cluster
//    meets at one barrier (arrive.release / wait.acquire): the buffer a
//    step writes was last read in the step before, which every CTA has left.
//  - c and n stay in registers of the thread that owns (row, column); the
//    pre-activations of step t + 1 are loaded while step t computes.
// The launch plan (cluster size, columns, rows, resident rows, threads and
// shared bytes) is made in Python (kernels/slstm_scan.py `plan_scan`) and
// checked here; a plan this kernel does not take returns
// cudaErrorInvalidValue.  Accurate expf / tanhf (no fast math).
//
// What paces it (scan_clock_split.py at the repo root counts cycles by
// phase on the card): a prefill step is its dot products (shared-memory
// reads of R and the bf16 unpacking), the gates on the warp that owns the
// cells, then the h exchange and the cluster barrier; decode waits on its R
// loads from global memory.
//
// The kernel launches on the stream it is given, does not synchronise and
// allocates nothing.  The launcher returns cudaGetLastError().

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

#define SCAN_MAX_WARPS 16     // threads = 32 * min(SCAN_MAX_WARPS, output units)
#define SCAN_MAX_ITEMS 2      // (row, column) cells a thread owns: rows * cols <= 2 * threads
#define SCAN_MAX_CLUSTER 16   // non-portable cluster size
#define SCAN_MAX_DH 2048
#define SCAN_SMEM_LIMIT 232448  // shared memory a block may use on sm_90 (227 KB)
#define IGATE_CLIP 5.0f

template <typename T> struct Elem;
template <> struct Elem<float> { typedef unsigned int Raw; enum { VEC = 4 }; };
template <> struct Elem<__nv_bfloat16> { typedef unsigned short Raw; enum { VEC = 8 }; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The value of an element of R read as its raw bits
__device__ __forceinline__ float raw_to_f32(unsigned int w) { return __uint_as_float(w); }
__device__ __forceinline__ float raw_to_f32(unsigned short w) { return __uint_as_float((unsigned int)w << 16); }

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ void unpack(const uint4& w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}

__device__ __forceinline__ void unpack(const uint4& w, float (&f)[8]) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // element 2k is the low half (little-endian)
    f[2 * k] = __uint_as_float(u[k] << 16);
    f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}

// One 16-byte unit of R at p: `valid` of its columns lie inside dh (the rest
// read as 0).  A 16-byte load where the unit is whole and aligned (dh a
// multiple of VEC), else element by element.
template <typename T>
__device__ __forceinline__ uint4 load_unit(const T* p, int valid, bool aligned) {
  constexpr int VEC = Elem<T>::VEC;
  if (aligned && valid >= VEC) return __ldg(reinterpret_cast<const uint4*>(p));
  union {
    uint4 v;
    typename Elem<T>::Raw e[VEC];
  } r;
  r.v = make_uint4(0u, 0u, 0u, 0u);
  const typename Elem<T>::Raw* q = reinterpret_cast<const typename Elem<T>::Raw*>(p);
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    if (k < valid) r.e[k] = __ldg(q + k);
  return r.v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// acc[b * VEC + k] += h[d][b] * R[d][e + k] for one unit w of input row d
template <int VEC, int SLOTS>
__device__ __forceinline__ void fma_unit(float (&acc)[VEC * SLOTS], const uint4& w, const float* h) {
  float wf[VEC];
  unpack(w, wf);
  float hv[SLOTS];
  if constexpr (SLOTS % 4 == 0) {
#pragma unroll
    for (int q = 0; q < SLOTS / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(h)[q];
      hv[4 * q] = v.x;
      hv[4 * q + 1] = v.y;
      hv[4 * q + 2] = v.z;
      hv[4 * q + 3] = v.w;
    }
  } else if constexpr (SLOTS == 2) {
    const float2 v = *reinterpret_cast<const float2*>(h);
    hv[0] = v.x;
    hv[1] = v.y;
  } else {
    hv[0] = h[0];
  }
#pragma unroll
  for (int b = 0; b < SLOTS; ++b)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[b * VEC + k] = fmaf(hv[b], wf[k], acc[b * VEC + k]);
}

// Sum each of the V values over the lanes of the warp that differ in the
// bits O >= UL of the lane index (the row lanes of one unit).  While a lane
// holds more than one value, each level (xor offset O) halves them: the lane
// keeps one half and adds its partner's copy of it; once one is left, the
// levels add the partner's sum.  Which values a lane ends with: lane_sums()
// below.
template <int V, int N, int O, int UL>
__device__ __forceinline__ void butterfly(float (&a)[V], int lane) {
  if constexpr (O >= UL) {
    if constexpr (N > 1) {
      constexpr int HALF = N / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const float send = up ? a[i] : a[i + HALF];
        const float keep = up ? a[i + HALF] : a[i];
        a[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      butterfly<V, HALF, O / 2, UL>(a, lane);
    } else {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], O);
      butterfly<V, 1, O / 2, UL>(a, lane);
    }
  }
}

// After butterfly<V, V, 16, UL>: the lane holds the sums of values base + i,
// i < count, and is the one lane of those holding the same sums that writes
// them where `writer`.
struct LaneSums {
  int base, count;
  bool writer;
};

__device__ __forceinline__ LaneSums lane_sums(int V, int lane, int ul_lanes) {
  LaneSums r = {0, V, true};
  int shared_bits = 0;
  for (int O = 16; O >= ul_lanes; O >>= 1) {
    if (r.count > 1) {
      r.count >>= 1;
      if (lane & O) r.base += r.count;
    } else {
      shared_bits |= O;
    }
  }
  r.writer = (lane & shared_bits) == 0;
  return r;
}

template <typename T>
__device__ __forceinline__ const T* gate_matrix(int g, const T* rz, const T* ri, const T* rf,
                                                const T* ro) {
  return g == 0 ? rz : g == 1 ? ri : g == 2 ? rf : ro;
}

// The 16-byte units of one input row that a warp reads side by side: 4, 2
// or 1, the largest that divides the units of a gate (U).
static __host__ __device__ __forceinline__ int unit_lanes(int U) { return U % 4 == 0 ? 4 : U % 2 == 0 ? 2 : 1; }

template <typename T, int SLOTS, int UL, bool SAVE>
__global__ void __launch_bounds__(32 * SCAN_MAX_WARPS, 1)
slstm_cluster_kernel(const T* __restrict__ pre, const T* __restrict__ rz, const T* __restrict__ ri,
                     const T* __restrict__ rf, const T* __restrict__ ro,
                     const float* __restrict__ c0, const float* __restrict__ n0,
                     const float* __restrict__ h0, T* __restrict__ h_all, float* __restrict__ c1,
                     float* __restrict__ n1, float* __restrict__ h1, float* __restrict__ saved, int B,
                     int S, int H, int dh, int cols, int rows, int resident) {
  constexpr int VEC = Elem<T>::VEC;
  constexpr int V = VEC * SLOTS;              // sums a lane carries for one unit
  constexpr int GB = V >= 64 ? 4 : 8;         // global units in flight a lane
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  // the work split of slstm_scan.py plan_scan: a warp slot reads UL
  // adjacent units (one gate) of RL = 32 / UL rows at a time; the UL slots of
  // a group of units take rows d = wq RL + dl + 32 k (wq < UL, dl < RL)
  const int U = cols / VEC, units = 4 * U;  // output units of this CTA; UL == unit_lanes(U)
  constexpr int RL = 32 / UL;
  const int hrows = gridDim.x * cols;
  uint4* r_sh = reinterpret_cast<uint4*>(smem);                           // [units / UL][resident][UL]
  float* hbuf = reinterpret_cast<float*>(smem + (size_t)units * resident * 16);  // 2 x [hrows][SLOTS]
  float* gpart = hbuf + 2 * hrows * SLOTS;                                // [UL][4][SLOTS][cols]
  float* hout = gpart + 4 * UL * SLOTS * cols;                            // [cols][SLOTS]
  const int hd = blockIdx.y;
  const int e0 = blockIdx.x * cols;
  const int b0 = blockIdx.z * rows;
  const int nb = min(rows, B - b0);  // rows of this batch group
  const bool clustered = S > 1 && gridDim.x > 1;
  // 16-byte loads of R where every row starts on 16 bytes
  const bool aligned = dh % VEC == 0 &&
                       ((reinterpret_cast<size_t>(rz) | reinterpret_cast<size_t>(ri) |
                         reinterpret_cast<size_t>(rf) | reinterpret_cast<size_t>(ro)) & 15) == 0;
  const size_t rhead = (size_t)hd * dh * dh;
  const size_t gate = (size_t)H * dh;  // stride between gates of one pre step

  // each lane stages the resident rows it reads in every step (the warp
  // slots below): UL x 16 contiguous bytes of RL rows a warp instruction
  const int ul = lane % UL, dl = lane / UL;  // unit and row lane
  for (int slot = warp; slot < units; slot += nwarps) {
    const int ou = slot / UL * UL + ul, e = e0 + ou % U * VEC;
    const T* src = gate_matrix(ou / U, rz, ri, rf, ro) + rhead + e;
    uint4* dst = r_sh + (size_t)(slot / UL) * resident * UL + ul;
    const bool whole = aligned && e + VEC <= dh;
    for (int d = slot % UL * RL + dl; d < resident; d += 32) {
      if (whole)
        cp_async16(dst + (size_t)d * UL, src + (size_t)d * dh);
      else
        dst[(size_t)d * UL] = load_unit(src + (size_t)d * dh, dh - e, false);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  for (int i = tid; i < hrows * SLOTS; i += blockDim.x) {
    const int d = i / SLOTS, b = i % SLOTS;
    hbuf[i] = (b < nb && d < dh) ? h0[((size_t)(b0 + b) * H + hd) * dh + d] : 0.0f;
  }
  for (int i = tid; i < SLOTS * cols; i += blockDim.x) hout[i] = 0.0f;

  // the (row, column) cells this thread owns: item idx = b * cols + e
  float c[SCAN_MAX_ITEMS], n[SCAN_MAX_ITEMS], hl[SCAN_MAX_ITEMS];
  T pn[SCAN_MAX_ITEMS][4];
  int ib[SCAN_MAX_ITEMS], ie[SCAN_MAX_ITEMS];  // -1: no cell; else its row and local column
  bool mine[SCAN_MAX_ITEMS];                   // a cell of the output (row < nb, column < dh)
#pragma unroll
  for (int j = 0; j < SCAN_MAX_ITEMS; ++j) {
    const int idx = tid + j * blockDim.x;
    ib[j] = idx < rows * cols ? idx / cols : -1;
    ie[j] = idx % cols;
    mine[j] = ib[j] >= 0 && ib[j] < nb && e0 + ie[j] < dh;
    c[j] = n[j] = hl[j] = 0.0f;
    if (mine[j]) {
      const int b = ib[j], e = e0 + ie[j];
      const size_t st = ((size_t)(b0 + b) * H + hd) * dh + e;
      c[j] = c0[st];
      n[j] = n0[st];
      hl[j] = h0[st];
      const T* p = pre + (size_t)(b0 + b) * S * 4 * gate + (size_t)hd * dh + e;
#pragma unroll
      for (int g = 0; g < 4; ++g) pn[j][g] = p[g * gate];
    }
  }
  const LaneSums ls = lane_sums(V, lane, UL);
  if (clustered)
    cluster_barrier();  // every CTA of the cluster has started and is set up
  else
    __syncthreads();

  for (int t = 0; t < S; ++t) {
    const float* hcur = hbuf + (t & 1) * hrows * SLOTS;
    float pc[SCAN_MAX_ITEMS][4];
#pragma unroll
    for (int j = 0; j < SCAN_MAX_ITEMS; ++j) {
#pragma unroll
      for (int g = 0; g < 4; ++g) pc[j][g] = mine[j] ? to_f32(pn[j][g]) : 0.0f;
      if (mine[j] && t + 1 < S) {  // prefetch step t + 1
        const T* p = pre + ((size_t)(b0 + ib[j]) * S + t + 1) * 4 * gate + (size_t)hd * dh + e0 + ie[j];
#pragma unroll
        for (int g = 0; g < 4; ++g) pn[j][g] = p[g * gate];
      }
    }

    // warp slot = (group, row quarter wq): rows d = r, r + 32, ... of
    // units grp UL + ul, r = wq RL + dl
    for (int slot = warp; slot < units; slot += nwarps) {
      const int grp = slot / UL, wq = slot % UL;
      const int ou = grp * UL + ul, g = ou / U, u = ou % U;
      const int e = e0 + u * VEC;
      const int r = wq * RL + dl;
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.0f;
      const uint4* rs = r_sh + (size_t)grp * resident * UL + ul;
#pragma unroll 4
      for (int d = r; d < resident; d += 32) fma_unit<VEC, SLOTS>(acc, rs[(size_t)d * UL], hcur + d * SLOTS);
      if (resident < dh) {
        const T* rg = gate_matrix(g, rz, ri, rf, ro) + rhead + e;
        for (int d0 = resident + r; d0 < dh; d0 += 32 * GB) {
          uint4 w[GB];
#pragma unroll
          for (int q = 0; q < GB; ++q) {
            const int d = d0 + 32 * q;
            w[q] = d < dh ? load_unit(rg + (size_t)d * dh, dh - e, aligned) : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int q = 0; q < GB; ++q) {
            const int d = d0 + 32 * q;
            if (d < dh) fma_unit<VEC, SLOTS>(acc, w[q], hcur + d * SLOTS);
          }
        }
      }
      butterfly<V, V, 16, UL>(acc, lane);
      if (ls.writer) {  // the slot's partial sums of unit (g, u)
        float* gp = gpart + (size_t)(wq * 4 + g) * SLOTS * cols + u * VEC;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (i < ls.count) {
            const int v = ls.base + i;
            gp[(v / VEC) * cols + v % VEC] = acc[i];
          }
        }
      }
    }
    __syncthreads();  // every partial gate sum of step t is in gpart

#pragma unroll
    for (int j = 0; j < SCAN_MAX_ITEMS; ++j) {
      if (ib[j] >= 0) {
        const int b = ib[j], e = ie[j];
        float h = 0.0f;
        if (mine[j]) {
          float gs[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {  // the UL slots' partials, in order
            gs[g] = 0.0f;
#pragma unroll
            for (int q = 0; q < UL; ++q) gs[g] += gpart[((size_t)(q * 4 + g) * SLOTS + b) * cols + e];
          }
          const float z = tanhf(pc[j][0] + gs[0]);
          const float ai = pc[j][1] + gs[1];
          const float i = expf(fminf(ai, IGATE_CLIP));
          const float f = sigmoid(pc[j][2] + gs[2]);
          const float o = sigmoid(pc[j][3] + gs[3]);
          c[j] = f * c[j] + i * z;
          n[j] = f * n[j] + i;
          h = o * c[j] / fmaxf(n[j], 1.0f);
          hl[j] = h;
          const size_t at = ((size_t)(b0 + b) * S + t) * gate + (size_t)hd * dh + e0 + e;
          store_as(h_all + at, h);
          if constexpr (SAVE) {  // the planes z, ai, f, o, c, n of slstm_scan_bwd_kernel
            const size_t plane = (size_t)B * S * gate;
            saved[at] = z;
            saved[plane + at] = ai;
            saved[2 * plane + at] = f;
            saved[3 * plane + at] = o;
            saved[4 * plane + at] = c[j];
            saved[5 * plane + at] = n[j];
          }
        }
        hout[e * SLOTS + b] = h;
      }
    }

    if (t + 1 < S) {  // h_t to every CTA of the cluster; the last step keeps it
      __syncthreads();  // hout is complete
      float* hnext = hbuf + ((t + 1) & 1) * hrows * SLOTS;
      const int q = cols * SLOTS / 4;  // float4 of this CTA's block of h_t
      const float4* src = reinterpret_cast<const float4*>(hout);
      const size_t at = (size_t)e0 * SLOTS / 4;
      if (clustered) {
        cg::cluster_group cluster = cg::this_cluster();
        for (int i = tid; i < (int)gridDim.x * q; i += blockDim.x) {
          float4* dst = reinterpret_cast<float4*>(cluster.map_shared_rank(hnext, i / q));
          dst[at + i % q] = src[i % q];
        }
        cluster_barrier();  // h_t is in every CTA; every CTA has left step t
      } else {
        for (int i = tid; i < q; i += blockDim.x) reinterpret_cast<float4*>(hnext)[at + i] = src[i];
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int j = 0; j < SCAN_MAX_ITEMS; ++j) {
    if (mine[j]) {
      const size_t st = ((size_t)(b0 + ib[j]) * H + hd) * dh + e0 + ie[j];
      c1[st] = c[j];
      n1[st] = n[j];
      h1[st] = hl[j];
    }
  }
  if (clustered) cluster_barrier();  // no CTA leaves while a peer may touch its shared memory
}

// The shared bytes a plan needs: the resident R units, two h buffers, the
// slots' partial gate sums and the CTA's block of h (the formula of
// plan_scan in Python).
static inline long long scan_smem(int units, int resident, int hrows, int slots, int cols) {
  const long long UL = unit_lanes(units / 4);
  return 16LL * units * resident + 4LL * slots * (2LL * hrows + (4 * UL + 1) * cols);
}

template <typename T, int SLOTS, int UL, bool SAVE>
static cudaError_t set_attributes() {
  auto kernel = slstm_cluster_kernel<T, SLOTS, UL, SAVE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SCAN_SMEM_LIMIT);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// A launch of `kernel` on grid (blocks, H, groups), as a cluster of
// `cluster` CTAs along x where cluster > 1; returns the launch's error.
template <typename Kernel, typename... Args>
static int launch_clustered(Kernel kernel, dim3 grid, int threads, int smem, int cluster, cudaStream_t st,
                            Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int SLOTS, int UL, bool SAVE>
static int launch_scan(const void* pre, const void* rz, const void* ri, const void* rf,
                       const void* ro, const void* c0, const void* n0, const void* h0,
                       void* h_all, void* c1, void* n1, void* h1, void* saved, int B, int S, int H,
                       int dh, int cluster, int cols, int rows, int resident, int threads, int smem,
                       cudaStream_t st) {
  cudaError_t err = set_attributes<T, SLOTS, UL, SAVE>();
  if (err != cudaSuccess) return (int)err;
  return launch_clustered(slstm_cluster_kernel<T, SLOTS, UL, SAVE>,
                          dim3((dh + cols - 1) / cols, H, (B + rows - 1) / rows), threads, smem, cluster,
                          st, (const T*)pre, (const T*)rz, (const T*)ri, (const T*)rf, (const T*)ro,
                          (const float*)c0, (const float*)n0, (const float*)h0, (T*)h_all, (float*)c1,
                          (float*)n1, (float*)h1, (float*)saved, B, S, H, dh, cols, rows, resident);
}

template <typename T, bool SAVE>
static int launch_slots(int slots, const void* pre, const void* rz, const void* ri, const void* rf,
                        const void* ro, const void* c0, const void* n0, const void* h0, void* h_all,
                        void* c1, void* n1, void* h1, void* saved, int B, int S, int H, int dh,
                        int cluster, int cols, int rows, int resident, int threads, int smem,
                        cudaStream_t st) {
#define SCAN_LAUNCH(N, L)                                                                       \
  launch_scan<T, N, L, SAVE>(pre, rz, ri, rf, ro, c0, n0, h0, h_all, c1, n1, h1, saved, B, S, H, \
                             dh, cluster, cols, rows, resident, threads, smem, st)
#define SCAN_LAUNCH_UL(N)                                     \
  switch (unit_lanes(cols / Elem<T>::VEC)) {                  \
    case 4: return SCAN_LAUNCH(N, 4);                         \
    case 2: return SCAN_LAUNCH(N, 2);                         \
    default: return SCAN_LAUNCH(N, 1);                        \
  }
  switch (slots) {
    case 1: SCAN_LAUNCH_UL(1)
    case 2: SCAN_LAUNCH_UL(2)
    case 4: SCAN_LAUNCH_UL(4)
    case 8: SCAN_LAUNCH_UL(8)
  }
#undef SCAN_LAUNCH_UL
#undef SCAN_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The checks of the plan and the launch of slstm_scan / slstm_scan_save.
template <bool SAVE>
static int scan_entry(const void* pre, const void* rz, const void* ri, const void* rf, const void* ro,
                      const void* c0, const void* n0, const void* h0, void* h_all, void* c1, void* n1,
                      void* h1, void* saved, int B, int S, int H, int dh, int bf16, int cluster,
                      int cols, int rows, int slots, int resident, int threads, int smem, void* stream) {
  const int vec = bf16 ? 8 : 4;
  if (B < 1 || S < 1 || H < 1 || dh < 1 || dh > SCAN_MAX_DH || cols < vec || cols % vec != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (dh + cols - 1) / cols, units = 4 * cols / vec;
  const int want_threads = 32 * (units < SCAN_MAX_WARPS ? units : SCAN_MAX_WARPS);
  if (cluster != (S > 1 && blocks > 1 ? blocks : 1) || cluster > SCAN_MAX_CLUSTER ||
      rows < 1 || rows > slots || threads != want_threads ||
      rows * cols > SCAN_MAX_ITEMS * threads || resident < 0 || resident > dh ||
      (resident != dh && resident % 32 != 0) ||
      smem != scan_smem(units, resident, blocks * cols, slots, cols) ||
      smem > SCAN_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch_slots<__nv_bfloat16, SAVE>(slots, pre, rz, ri, rf, ro, c0, n0, h0, h_all, c1, n1, h1,
                                             saved, B, S, H, dh, cluster, cols, rows, resident, threads,
                                             smem, st);
  return launch_slots<float, SAVE>(slots, pre, rz, ri, rf, ro, c0, n0, h0, h_all, c1, n1, h1, saved, B,
                                   S, H, dh, cluster, cols, rows, resident, threads, smem, st);
}

// ---------------------------------------------------------------------------
// slstm_scan_bwd_kernel<T, SLOTS>: the backward of the scan, in one launch.
//
// It replaces no Pallas kernel: the reference trains through the
// jax.lax.scan of src/repro/models/xlstm.py slstm_block (:213), which JAX
// differentiates.  This is that derivative for the card, fed by the saving
// forward (slstm_cluster_kernel<T, SLOTS, UL, true>), which writes per step
// and in float32 the planes z, ai (the input gate's pre-activation, before
// the clip), f, o, c_t and n_t, each (B, S, H, dh), one after another in
// `saved`.  Reverse time, per cell (b, h, column d), with dh_t the upstream
// dh_all[t] plus the recurrent dh carried from step t + 1, and dc, dn
// carried in registers (m = max(n_t, 1), i = exp(min(ai, 5))):
//     do = dh c_t / m      dc += dh o / m      dn -= w_n dh o c_t / m^2
//     gz = dc i (1 - z^2)  gi = (dc z + dn) i w_i
//     gf = (dc c_{t-1} + dn n_{t-1}) f (1 - f)     go = do o (1 - o)
//     dh_{t-1}[d] = sum over gates g and columns e of R_g[d, e] g_g[e]
//     dc *= f   dn *= f
// The ties follow the JVP of jax.lax.min / max: w_i is 1 below the clip,
// 1/2 at ai == 5 exactly and 0 above it (decided on the saved float32 ai,
// never on i: expf of values just under 5 can round to expf(5)); w_n is 1
// above n_t = 1, 1/2 at it and 0 below.  It writes g (B, S, 4, H, dh) float32
// (the gradient of pre, before its cast) and the carries into step 0
// (dc0, dn0, dh0); the gradient of R (the sum over B S of h_{t-1} g_t) is a
// plain product that the wrapper leaves to cuBLAS, as the reference leaves it
// to XLA.
//
// What bounds it: the dh products, 2 B S 4 H dh^2 float32 operations, as in
// the forward; the bytes (the saved planes read, g written) are a fifth of
// that time at the train shape.  The S steps are sequential.
//
// Design: the mirror of the forward.  The grid and the cluster are the
// forward's (column blocks x heads x batch groups, the column blocks of one
// (head, batch group) a cluster), and a CTA's block of columns d is both the
// cells it owns and its rows of R.  The wrapper hands R over as rt (H, 4, dh,
// dh), rt[h, g, e, d] = R_g[h, d, e], so that the CTA's slice (every gate
// row k = g dh + e, its `cols` columns d) is read in contiguous runs; the
// first `resident` rows k of it sit in shared memory for the launch
// (all of them at bf16 dh = 512, 128 KB), the rest is read from global
// memory every step.  Each step: the gates of the CTA's cells (one thread a
// cell, at most 4 rows x 128 columns); its block of g to every CTA of the
// cluster through distributed shared memory, into the one of two buffers
// that the step's parity names, behind one cluster barrier; then the dh
// products of its columns, each column's 4 dh terms split over
// threads / cols thread groups and their partial sums added in order.  The
// saved values of step t - 1 are loaded while step t's exchange and
// products run.  Accurate expf (no fast math).  A simple kernel: the
// products are one 2- or 4-byte R read a thread and a broadcast read of g
// per term.
// ---------------------------------------------------------------------------

#define SCAN_BWD_THREADS 512
#define SCAN_BWD_MAX_ROWS 4

template <int SLOTS>
__device__ __forceinline__ void load_slots(const float* p, float (&v)[SLOTS]) {
  if constexpr (SLOTS == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (SLOTS == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

// What the backward reads of one cell at one step
struct BwdStep {
  float z, ai, f, o, c, n, c_prev, n_prev, dh_up;
};

// The cell at `at` (an index of the (B, S, H, dh) planes) at step t; the
// state before step 0 is c0 / n0 at `st0`.
template <typename T>
__device__ __forceinline__ BwdStep load_bwd_step(const float* saved, const T* dh_all, const float* c0,
                                                 const float* n0, size_t plane, size_t gate, size_t at,
                                                 size_t st0, int t) {
  BwdStep r;
  r.z = saved[at];
  r.ai = saved[plane + at];
  r.f = saved[2 * plane + at];
  r.o = saved[3 * plane + at];
  r.c = saved[4 * plane + at];
  r.n = saved[5 * plane + at];
  r.c_prev = t > 0 ? saved[4 * plane + at - gate] : c0[st0];
  r.n_prev = t > 0 ? saved[5 * plane + at - gate] : n0[st0];
  r.dh_up = to_f32(dh_all[at]);
  return r;
}

template <typename T, int SLOTS>
__global__ void __launch_bounds__(SCAN_BWD_THREADS, 1)
slstm_scan_bwd_kernel(const T* __restrict__ dh_all, const float* __restrict__ saved,
                      const T* __restrict__ rt, const float* __restrict__ c0,
                      const float* __restrict__ n0, const float* __restrict__ dc1,
                      const float* __restrict__ dn1, const float* __restrict__ dh1,
                      float* __restrict__ g, float* __restrict__ dc0, float* __restrict__ dn0,
                      float* __restrict__ dh0, int B, int S, int H, int dh, int cols, int rows,
                      int resident) {
  typedef typename Elem<T>::Raw Raw;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int hd = blockIdx.y, d0 = blockIdx.x * cols, b0 = blockIdx.z * rows;
  const int nb = min(rows, B - b0);  // rows of this batch group
  const int hrows = gridDim.x * cols;
  const int kgroups = blockDim.x / cols;  // thread groups splitting a column's dh terms
  const bool clustered = gridDim.x > 1;
  float* gbuf = reinterpret_cast<float*>(smem);    // 2 x [4][hrows][SLOTS]: g of the head
  float* part = gbuf + 8 * hrows * SLOTS;          // [kgroups][SLOTS][cols]
  float* gout = part + kgroups * SLOTS * cols;     // [4][cols][SLOTS]: this CTA's block of g
  Raw* r_sh = reinterpret_cast<Raw*>(gout + 4 * cols * SLOTS);  // [resident][cols]
  const size_t gate = (size_t)H * dh;
  const size_t plane = (size_t)B * S * gate;
  const Raw* rh = reinterpret_cast<const Raw*>(rt) + (size_t)hd * 4 * dh * dh;  // [4 dh][dh]

  for (int i = tid; i < resident * cols; i += blockDim.x) {
    const int k = i / cols, d = d0 + i % cols;
    r_sh[i] = d < dh ? rh[(size_t)k * dh + d] : (Raw)0;
  }
  for (int i = tid; i < 4 * cols * SLOTS; i += blockDim.x) gout[i] = 0.0f;

  // the cell this thread owns, (row cb, column d0 + cl), and, in the
  // products, its thread group cb (< kgroups) of column d0 + cl
  const int cb = tid / cols, cl = tid % cols, d = d0 + cl;
  const bool owner = cb < rows;
  const bool mine = owner && cb < nb && d < dh;
  const bool summing = cb < kgroups;
  const size_t st0 = ((size_t)(b0 + cb) * H + hd) * dh + d;  // index of the (B, H, dh) state
  const size_t at0 = (size_t)(b0 + cb) * S * gate + (size_t)hd * dh + d;  // step 0's plane index
  float dc = 0.0f, dn = 0.0f, dhr = 0.0f;
  BwdStep cur = {};
  if (mine) {
    dc = dc1[st0];
    dn = dn1[st0];
    dhr = dh1[st0];
    cur = load_bwd_step(saved, dh_all, c0, n0, plane, gate, at0 + (size_t)(S - 1) * gate, st0, S - 1);
  }
  if (clustered)
    cluster_barrier();  // every CTA of the cluster has started and is set up
  else
    __syncthreads();

  for (int t = S - 1; t >= 0; --t) {
    float* gcur = gbuf + (t & 1) * 4 * hrows * SLOTS;
    if (owner) {  // the gate gradients of step t
      float gg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (mine) {
        const float dht = cur.dh_up + dhr;
        const float m = fmaxf(cur.n, 1.0f);
        const float wn = cur.n > 1.0f ? 1.0f : (cur.n == 1.0f ? 0.5f : 0.0f);
        const float wi = cur.ai < IGATE_CLIP ? 1.0f : (cur.ai == IGATE_CLIP ? 0.5f : 0.0f);
        const float i = expf(fminf(cur.ai, IGATE_CLIP));
        const float d_o = dht * cur.c / m;
        dc = dc + dht * cur.o / m;
        dn = dn - wn * (dht * cur.o * cur.c / (m * m));
        gg[0] = dc * i * (1.0f - cur.z * cur.z);
        gg[1] = (dc * cur.z + dn) * i * wi;
        gg[2] = (dc * cur.c_prev + dn * cur.n_prev) * cur.f * (1.0f - cur.f);
        gg[3] = d_o * cur.o * (1.0f - cur.o);
        dc = dc * cur.f;
        dn = dn * cur.f;
        float* gp = g + (size_t)(b0 + cb) * S * 4 * gate + (size_t)t * 4 * gate + (size_t)hd * dh + d;
#pragma unroll
        for (int q = 0; q < 4; ++q) gp[q * gate] = gg[q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) gout[(q * cols + cl) * SLOTS + cb] = gg[q];
    }
    if (mine && t > 0)  // step t - 1's saved values, in flight over the exchange and products
      cur = load_bwd_step(saved, dh_all, c0, n0, plane, gate, at0 + (size_t)(t - 1) * gate, st0, t - 1);
    __syncthreads();  // gout is complete

    // the CTA's block of g_t to every CTA of the cluster
    const int q4 = cols * SLOTS / 4;  // float4 of one gate's block
    const float4* src = reinterpret_cast<const float4*>(gout);
    if (clustered) {
      cg::cluster_group cluster = cg::this_cluster();
      for (int i = tid; i < (int)gridDim.x * 4 * q4; i += blockDim.x) {
        const int j = i % (4 * q4);
        float4* dst = reinterpret_cast<float4*>(cluster.map_shared_rank(gcur, i / (4 * q4)));
        dst[((size_t)(j / q4) * hrows + d0) * SLOTS / 4 + j % q4] = src[j];
      }
      cluster_barrier();  // g_t is in every CTA; every CTA has left step t + 1
    } else {
      for (int j = tid; j < 4 * q4; j += blockDim.x)
        reinterpret_cast<float4*>(gcur)[((size_t)(j / q4) * hrows + d0) * SLOTS / 4 + j % q4] = src[j];
      __syncthreads();
    }

    // dh_{t-1} of the CTA's columns: thread group cb takes the terms
    // e = cb, cb + kgroups, ... of each gate
    if (summing) {
      float acc[SLOTS];
#pragma unroll
      for (int b = 0; b < SLOTS; ++b) acc[b] = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* gq = gcur + (size_t)q * hrows * SLOTS;
        const int kq = q * dh;                               // gate q's first row of rt
        const int e_res = min(max(resident - kq, 0), dh);    // its rows in shared memory
        int e = cb;
#pragma unroll 4
        for (; e < e_res; e += kgroups) {
          const float wf = raw_to_f32(r_sh[(size_t)(kq + e) * cols + cl]);
          float gv[SLOTS];
          load_slots<SLOTS>(gq + e * SLOTS, gv);
#pragma unroll
          for (int b = 0; b < SLOTS; ++b) acc[b] = fmaf(wf, gv[b], acc[b]);
        }
        if (d < dh) {
          for (; e < dh; e += kgroups) {
            const float wf = raw_to_f32(__ldg(rh + (size_t)(kq + e) * dh + d));
            float gv[SLOTS];
            load_slots<SLOTS>(gq + e * SLOTS, gv);
#pragma unroll
            for (int b = 0; b < SLOTS; ++b) acc[b] = fmaf(wf, gv[b], acc[b]);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < SLOTS; ++b) part[(cb * SLOTS + b) * cols + cl] = acc[b];
    }
    __syncthreads();  // every partial sum of step t is in part
    if (owner) {
      float s = 0.0f;
      for (int q = 0; q < kgroups; ++q) s += part[(q * SLOTS + cb) * cols + cl];
      dhr = s;
    }
  }

  if (mine) {
    dc0[st0] = dc;
    dn0[st0] = dn;
    dh0[st0] = dhr;
  }
  if (clustered) cluster_barrier();  // every CTA leaves after its peers' last exchange
}

template <typename T, int SLOTS>
static cudaError_t set_bwd_attributes() {
  auto kernel = slstm_scan_bwd_kernel<T, SLOTS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SCAN_SMEM_LIMIT);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <typename T, int SLOTS>
static int launch_bwd(const void* dh_all, const void* saved, const void* rt, const void* c0, const void* n0,
                      const void* dc1, const void* dn1, const void* dh1, void* g, void* dc0, void* dn0,
                      void* dh0, int B, int S, int H, int dh, int cluster, int cols, int rows,
                      int resident, int smem, cudaStream_t st) {
  cudaError_t err = set_bwd_attributes<T, SLOTS>();
  if (err != cudaSuccess) return (int)err;
  return launch_clustered(slstm_scan_bwd_kernel<T, SLOTS>,
                          dim3((dh + cols - 1) / cols, H, (B + rows - 1) / rows), SCAN_BWD_THREADS, smem,
                          cluster, st, (const T*)dh_all, (const float*)saved, (const T*)rt,
                          (const float*)c0, (const float*)n0, (const float*)dc1, (const float*)dn1,
                          (const float*)dh1, (float*)g, (float*)dc0, (float*)dn0, (float*)dh0, B, S, H,
                          dh, cols, rows, resident);
}

template <typename T>
static int launch_bwd_slots(int slots, const void* dh_all, const void* saved, const void* rt,
                            const void* c0, const void* n0, const void* dc1, const void* dn1,
                            const void* dh1, void* g, void* dc0, void* dn0, void* dh0, int B, int S,
                            int H, int dh, int cluster, int cols, int rows, int resident, int smem,
                            cudaStream_t st) {
#define BWD_LAUNCH(N)                                                                              \
  return launch_bwd<T, N>(dh_all, saved, rt, c0, n0, dc1, dn1, dh1, g, dc0, dn0, dh0, B, S, H, dh, \
                          cluster, cols, rows, resident, smem, st)
  switch (slots) {
    case 1: BWD_LAUNCH(1);
    case 2: BWD_LAUNCH(2);
    case 4: BWD_LAUNCH(4);
  }
#undef BWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <typename Kernel>
static int max_active_clusters(Kernel kernel, int cluster, int threads, int smem) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // clear it: an unschedulable size is an answer, not a fault
    return 0;
  }
  return n;
}
