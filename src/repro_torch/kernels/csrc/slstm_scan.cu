// Fused sLSTM recurrence for Hopper (sm_90a), plain C interface.
//
//   slstm_scan_kernel<T>  replaces src/repro/kernels/slstm_scan.py::_kernel
//                 (entry slstm_scan_pallas): the whole (B, S) scan of
//                     z = tanh(pre_z + h R_z)      i = exp(min(pre_i + h R_i, 5))
//                     f = sigmoid(pre_f + h R_f)   o = sigmoid(pre_o + h R_o)
//                     c' = f c + i z    n' = f n + i    h' = o c' / max(n', 1)
//                 per (batch row, head), in one launch, returning every h and
//                 the final (c, n, h).
//
// Shapes: pre (B, S, 4, H, dh) and h_all (B, S, H, dh) in T; R_z, R_i, R_f,
// R_o (H, dh, dh) in T; c0, n0, h0 and c1, n1, h1 (B, H, dh) float32.  T is
// float or __nv_bfloat16; every product and sum is float32, and h_all is
// rounded once to T (round to nearest even), where the reference rounds hs.
//
// What bounds it on this card.  Per step a (b, h) pair needs the four dh x dh
// recurrent matrices of its head (2 MB in bf16 at dh = 512) against a dh-long
// h.  Over a call the function moves 4 H dh^2 weights once and does
// 2 B S 4 H dh^2 float32 operations; the bound is bytes at decode (S = 1) and
// float32 operations in prefill.  The S steps are strictly sequential, which
// the bound does not see.
//
// Design (v1, simple and right).  One block per (b, h); the sequence loop runs
// inside the block, so a call is one launch.  A thread owns output columns
// e = threadIdx.x + j * blockDim.x (j < MAX_COLS) and keeps their c and n in
// registers; h_{t-1} sits in shared memory as float32.  At step t a thread
// forms its four dot products sum_d h[d] R_g[h, d, e], reading R from global
// memory so neighbouring threads read neighbouring e (coalesced), adds
// pre[b, t, g, h, e], applies the gates and writes h_all[b, t, h, e].  Two
// __syncthreads() fence the shared h between steps.  A step's R comes from L2
// at its latency, so the dot-product loop is unrolled 16 deep: 64 loads of
// each thread are in flight together (the 512-thread launch bound leaves the
// registers for them).  The outputs are separate
// buffers from the initial state, so nothing is read after it is
// overwritten.  Every step streams the head's R from L2 into one SM: that is
// the gap to the bound.  The later design holds each head's R resident in the
// shared memory of a thread-block cluster (about 16 CTAs, 128 KB each) and
// exchanges h through distributed shared memory every step.
//
// The kernel launches on the stream it is given, does not synchronise and
// allocates nothing.  The launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#define MAX_COLS 4          // output columns per thread
#define MAX_THREADS 512     // threads per block: dh <= MAX_COLS * MAX_THREADS
#define IGATE_CLIP 5.0f

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
slstm_scan_kernel(const T* __restrict__ pre, const T* __restrict__ rz, const T* __restrict__ ri,
                  const T* __restrict__ rf, const T* __restrict__ ro,
                  const float* __restrict__ c0, const float* __restrict__ n0,
                  const float* __restrict__ h0, T* __restrict__ h_all, float* __restrict__ c1,
                  float* __restrict__ n1, float* __restrict__ h1, int S, int H, int dh) {
  extern __shared__ float h_sh[];  // h_{t-1}, dh floats
  const int b = blockIdx.x / H;
  const int hd = blockIdx.x % H;
  const size_t state = ((size_t)b * H + hd) * dh;
  const size_t rbase = (size_t)hd * dh * dh;
  const size_t gate = (size_t)H * dh;  // stride between gates of one pre step

  float c[MAX_COLS], n[MAX_COLS], hn[MAX_COLS];
#pragma unroll
  for (int j = 0; j < MAX_COLS; ++j) {
    const int e = threadIdx.x + j * blockDim.x;
    c[j] = n[j] = hn[j] = 0.0f;
    if (e < dh) {
      c[j] = c0[state + e];
      n[j] = n0[state + e];
      hn[j] = h0[state + e];
      h_sh[e] = hn[j];
    }
  }
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    const T* pre_t = pre + ((size_t)b * S + t) * 4 * gate + (size_t)hd * dh;
    T* out_t = h_all + ((size_t)b * S + t) * gate + (size_t)hd * dh;
#pragma unroll
    for (int j = 0; j < MAX_COLS; ++j) {
      const int e = threadIdx.x + j * blockDim.x;
      if (e < dh) {
        const T* pz = rz + rbase + e;
        const T* pi = ri + rbase + e;
        const T* pf = rf + rbase + e;
        const T* po = ro + rbase + e;
        float az = 0.0f, ai = 0.0f, af = 0.0f, ao = 0.0f;
        // 16 loop steps' loads in flight together (a pragma takes no macro)
#pragma unroll 16
        for (int d = 0; d < dh; ++d) {
          const float hv = h_sh[d];
          const size_t off = (size_t)d * dh;
          az = fmaf(hv, to_f32(pz[off]), az);
          ai = fmaf(hv, to_f32(pi[off]), ai);
          af = fmaf(hv, to_f32(pf[off]), af);
          ao = fmaf(hv, to_f32(po[off]), ao);
        }
        const float z = tanhf(to_f32(pre_t[e]) + az);
        const float i = expf(fminf(to_f32(pre_t[gate + e]) + ai, IGATE_CLIP));
        const float f = sigmoid(to_f32(pre_t[2 * gate + e]) + af);
        const float o = sigmoid(to_f32(pre_t[3 * gate + e]) + ao);
        c[j] = f * c[j] + i * z;
        n[j] = f * n[j] + i;
        hn[j] = o * c[j] / fmaxf(n[j], 1.0f);
        store_as(out_t + e, hn[j]);
      }
    }
    __syncthreads();  // every thread has read h_{t-1}
#pragma unroll
    for (int j = 0; j < MAX_COLS; ++j) {
      const int e = threadIdx.x + j * blockDim.x;
      if (e < dh) h_sh[e] = hn[j];
    }
    __syncthreads();  // h_t is complete
  }

#pragma unroll
  for (int j = 0; j < MAX_COLS; ++j) {
    const int e = threadIdx.x + j * blockDim.x;
    if (e < dh) {
      c1[state + e] = c[j];
      n1[state + e] = n[j];
      h1[state + e] = hn[j];
    }
  }
}

template <typename T>
static int launch_scan(const void* pre, const void* rz, const void* ri, const void* rf,
                       const void* ro, const void* c0, const void* n0, const void* h0,
                       void* h_all, void* c1, void* n1, void* h1, int B, int S, int H, int dh,
                       cudaStream_t st) {
  // the smallest multiple of 32 threads that covers dh in MAX_COLS passes
  int cols = (dh + MAX_THREADS - 1) / MAX_THREADS;
  int threads = ((dh + cols - 1) / cols + 31) / 32 * 32;
  slstm_scan_kernel<T><<<B * H, threads, (size_t)dh * sizeof(float), st>>>(
      (const T*)pre, (const T*)rz, (const T*)ri, (const T*)rf, (const T*)ro, (const float*)c0,
      (const float*)n0, (const float*)h0, (T*)h_all, (float*)c1, (float*)n1, (float*)h1, S, H,
      dh);
  return (int)cudaGetLastError();
}

extern "C" {

// All pointers are contiguous device pointers (layouts above).  bf16 != 0
// selects T = __nv_bfloat16 for pre, R and h_all, else float.  Returns
// cudaErrorInvalidValue for shapes the kernel does not take.
int slstm_scan(const void* pre, const void* rz, const void* ri, const void* rf, const void* ro,
               const void* c0, const void* n0, const void* h0, void* h_all, void* c1, void* n1,
               void* h1, int B, int S, int H, int dh, int bf16, void* stream) {
  if (B < 1 || S < 1 || H < 1 || dh < 1 || dh > MAX_COLS * MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch_scan<__nv_bfloat16>(pre, rz, ri, rf, ro, c0, n0, h0, h_all, c1, n1, h1, B, S,
                                      H, dh, st);
  return launch_scan<float>(pre, rz, ri, rf, ro, c0, n0, h0, h_all, c1, n1, h1, B, S, H, dh, st);
}

}  // extern "C"
