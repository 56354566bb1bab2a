// The sLSTM scan's training entries (plain C interface): the saving forward
// and the backward.  The kernels, their design notes and launchers are in
// slstm_scan.cuh; a source of its own so that nvcc builds these
// instantiations beside slstm_scan.cu's.

#include "slstm_scan.cuh"

// The shared bytes of a backward plan: two buffers of the head's g, the
// partial sums, the CTA's block of g, the resident rows of its R slice (the
// formula of plan_scan_bwd in Python).
static long long bwd_smem(int hrows, int slots, int cols, int threads, int resident, int esize) {
  const long long kgroups = threads / cols;
  return 4LL * slots * (8LL * hrows + kgroups * cols + 4LL * cols) + (long long)resident * cols * esize;
}

extern "C" {

// slstm_scan that also writes `saved` (6, B, S, H, dh) float32: the planes
// z, ai, f, o, c, n of every step, for slstm_scan_bwd.
int slstm_scan_save(const void* pre, const void* rz, const void* ri, const void* rf, const void* ro,
                    const void* c0, const void* n0, const void* h0, void* h_all, void* c1, void* n1,
                    void* h1, void* saved, int B, int S, int H, int dh, int bf16, int cluster, int cols,
                    int rows, int slots, int resident, int threads, int smem, void* stream) {
  return scan_entry<true>(pre, rz, ri, rf, ro, c0, n0, h0, h_all, c1, n1, h1, saved, B, S, H, dh, bf16,
                          cluster, cols, rows, slots, resident, threads, smem, stream);
}

// The backward: dh_all (B, S, H, dh) in T (the gradient of h_all), saved
// (6, B, S, H, dh) float32 (slstm_scan_save's), rt (H, 4, dh, dh) in T
// (rt[h, g, e, d] = R_g[h, d, e]), c0 / n0 and the carries' gradients dc1 /
// dn1 / dh1 (B, H, dh) float32; writes g (B, S, 4, H, dh) and dc0 / dn0 / dh0
// (B, H, dh), float32.  The last seven ints are the plan of
// kernels/slstm_scan.py `plan_scan_bwd`: cluster size, columns a CTA takes,
// batch rows a CTA takes, the compiled row slots, the resident rows of rt,
// threads and dynamic shared bytes.  Returns cudaErrorInvalidValue for shapes
// or a plan the kernel does not take.
int slstm_scan_bwd(const void* dh_all, const void* saved, const void* rt, const void* c0, const void* n0,
                   const void* dc1, const void* dn1, const void* dh1, void* g, void* dc0, void* dn0,
                   void* dh0, int B, int S, int H, int dh, int bf16, int cluster, int cols, int rows,
                   int slots, int resident, int threads, int smem, void* stream) {
  const int vec = bf16 ? 8 : 4;
  if (B < 1 || S < 1 || H < 1 || dh < 1 || dh > SCAN_MAX_DH || cols < vec || cols % vec != 0 ||
      cols > SCAN_BWD_THREADS)
    return (int)cudaErrorInvalidValue;
  const int blocks = (dh + cols - 1) / cols;
  if (cluster != (blocks > 1 ? blocks : 1) || cluster > SCAN_MAX_CLUSTER || threads != SCAN_BWD_THREADS ||
      (slots != 1 && slots != 2 && slots != 4) || rows < 1 || rows > slots || rows * cols > threads ||
      resident < 0 || resident > 4 * dh ||
      smem != bwd_smem(blocks * cols, slots, cols, threads, resident, bf16 ? 2 : 4) ||
      smem > SCAN_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch_bwd_slots<__nv_bfloat16>(slots, dh_all, saved, rt, c0, n0, dc1, dn1, dh1, g, dc0, dn0,
                                           dh0, B, S, H, dh, cluster, cols, rows, resident, smem, st);
  return launch_bwd_slots<float>(slots, dh_all, saved, rt, c0, n0, dc1, dn1, dh1, g, dc0, dn0, dh0, B, S,
                                 H, dh, cluster, cols, rows, resident, smem, st);
}

// The same for slstm_scan_bwd_kernel (4 row slots; `threads` must be
// SCAN_BWD_THREADS).
int slstm_scan_bwd_max_clusters(int bf16, int cluster, int threads, int smem) {
  if (threads != SCAN_BWD_THREADS) return -(int)cudaErrorInvalidValue;
  cudaError_t err = bf16 ? set_bwd_attributes<__nv_bfloat16, 4>() : set_bwd_attributes<float, 4>();
  if (err != cudaSuccess) return -(int)err;
  return bf16 ? max_active_clusters(slstm_scan_bwd_kernel<__nv_bfloat16, 4>, cluster, threads, smem)
              : max_active_clusters(slstm_scan_bwd_kernel<float, 4>, cluster, threads, smem);
}

}  // extern "C"
