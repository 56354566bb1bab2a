// Fused sLSTM recurrence for Hopper (sm_90a), plain C interface.
//
//   slstm_cluster_kernel<T, SLOTS, UL>  replaces src/repro/kernels/
//                 slstm_scan.py::_kernel (entry slstm_scan_pallas): the whole
//                 (B, S) scan of
//                     z = tanh(pre_z + h R_z)      i = exp(min(pre_i + h R_i, 5))
//                     f = sigmoid(pre_f + h R_f)   o = sigmoid(pre_o + h R_o)
//                     c' = f c + i z    n' = f n + i    h' = o c' / max(n', 1)
//                 in one launch, returning every h and the final (c, n, h).
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

template <typename T, int SLOTS, int UL>
__global__ void __launch_bounds__(32 * SCAN_MAX_WARPS, 1)
slstm_cluster_kernel(const T* __restrict__ pre, const T* __restrict__ rz, const T* __restrict__ ri,
                     const T* __restrict__ rf, const T* __restrict__ ro,
                     const float* __restrict__ c0, const float* __restrict__ n0,
                     const float* __restrict__ h0, T* __restrict__ h_all, float* __restrict__ c1,
                     float* __restrict__ n1, float* __restrict__ h1, int B, int S, int H, int dh,
                     int cols, int rows, int resident) {
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
          const float i = expf(fminf(pc[j][1] + gs[1], IGATE_CLIP));
          const float f = sigmoid(pc[j][2] + gs[2]);
          const float o = sigmoid(pc[j][3] + gs[3]);
          c[j] = f * c[j] + i * z;
          n[j] = f * n[j] + i;
          h = o * c[j] / fmaxf(n[j], 1.0f);
          hl[j] = h;
          store_as(h_all + ((size_t)(b0 + b) * S + t) * gate + (size_t)hd * dh + e0 + e, h);
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
static long long scan_smem(int units, int resident, int hrows, int slots, int cols) {
  const long long UL = unit_lanes(units / 4);
  return 16LL * units * resident + 4LL * slots * (2LL * hrows + (4 * UL + 1) * cols);
}

template <typename T, int SLOTS, int UL>
static cudaError_t set_attributes() {
  auto kernel = slstm_cluster_kernel<T, SLOTS, UL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SCAN_SMEM_LIMIT);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <typename T, int SLOTS, int UL>
static int launch_scan(const void* pre, const void* rz, const void* ri, const void* rf,
                       const void* ro, const void* c0, const void* n0, const void* h0,
                       void* h_all, void* c1, void* n1, void* h1, int B, int S, int H, int dh,
                       int cluster, int cols, int rows, int resident, int threads, int smem,
                       cudaStream_t st) {
  cudaError_t err = set_attributes<T, SLOTS, UL>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((dh + cols - 1) / cols, H, (B + rows - 1) / rows);
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
  err = cudaLaunchKernelEx(&cfg, slstm_cluster_kernel<T, SLOTS, UL>, (const T*)pre, (const T*)rz,
                           (const T*)ri, (const T*)rf, (const T*)ro, (const float*)c0,
                           (const float*)n0, (const float*)h0, (T*)h_all, (float*)c1, (float*)n1,
                           (float*)h1, B, S, H, dh, cols, rows, resident);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_slots(int slots, const void* pre, const void* rz, const void* ri, const void* rf,
                        const void* ro, const void* c0, const void* n0, const void* h0, void* h_all,
                        void* c1, void* n1, void* h1, int B, int S, int H, int dh, int cluster,
                        int cols, int rows, int resident, int threads, int smem, cudaStream_t st) {
#define SCAN_LAUNCH(N, L)                                                                        \
  launch_scan<T, N, L>(pre, rz, ri, rf, ro, c0, n0, h0, h_all, c1, n1, h1, B, S, H, dh, cluster, \
                       cols, rows, resident, threads, smem, st)
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

extern "C" {

// All pointers are contiguous device pointers (layouts above).  bf16 != 0
// selects T = __nv_bfloat16 for pre, R and h_all, else float.  The last eight
// ints are the launch plan of kernels/slstm_scan.py `plan_scan`: cluster size,
// columns a CTA takes, batch rows a CTA takes, the compiled row slots, the
// resident rows, threads and dynamic shared bytes.  Returns
// cudaErrorInvalidValue for shapes or a plan the kernel does not take.
int slstm_scan(const void* pre, const void* rz, const void* ri, const void* rf, const void* ro,
               const void* c0, const void* n0, const void* h0, void* h_all, void* c1, void* n1,
               void* h1, int B, int S, int H, int dh, int bf16, int cluster, int cols, int rows,
               int slots, int resident, int threads, int smem, void* stream) {
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
    return launch_slots<__nv_bfloat16>(slots, pre, rz, ri, rf, ro, c0, n0, h0, h_all, c1, n1, h1, B,
                                       S, H, dh, cluster, cols, rows, resident, threads, smem, st);
  return launch_slots<float>(slots, pre, rz, ri, rf, ro, c0, n0, h0, h_all, c1, n1, h1, B, S, H,
                             dh, cluster, cols, rows, resident, threads, smem, st);
}

// How many clusters of `cluster` CTAs (each of `threads` threads and `smem`
// dynamic shared bytes) the card holds at once, for the widest instantiation
// of T (8 row slots); 0 where such a cluster cannot be scheduled, a negative
// cudaError where the query fails.
int slstm_scan_max_clusters(int bf16, int cluster, int threads, int smem) {
  cudaError_t err = bf16 ? set_attributes<__nv_bfloat16, 8, 4>() : set_attributes<float, 8, 4>();
  if (err != cudaSuccess) return -(int)err;
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
  err = bf16 ? cudaOccupancyMaxActiveClusters(&n, slstm_cluster_kernel<__nv_bfloat16, 8, 4>, &cfg)
             : cudaOccupancyMaxActiveClusters(&n, slstm_cluster_kernel<float, 8, 4>, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: an unschedulable size is an answer, not a fault
    return 0;
  }
  return n;
}

}  // extern "C"
