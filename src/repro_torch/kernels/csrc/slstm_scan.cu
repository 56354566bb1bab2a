// The sLSTM scan's serving entries (plain C interface); the kernels, their
// design notes and launchers are in slstm_scan.cuh.

#include "slstm_scan.cuh"

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
  return scan_entry<false>(pre, rz, ri, rf, ro, c0, n0, h0, h_all, c1, n1, h1, nullptr, B, S, H, dh,
                           bf16, cluster, cols, rows, slots, resident, threads, smem, stream);
}

// How many clusters of `cluster` CTAs (each of `threads` threads and `smem`
// dynamic shared bytes) the card holds at once, for the widest instantiation
// of T (8 row slots); 0 where such a cluster cannot be scheduled, a negative
// cudaError where the query fails.
int slstm_scan_max_clusters(int bf16, int cluster, int threads, int smem) {
  cudaError_t err = bf16 ? set_attributes<__nv_bfloat16, 8, 4, false>() : set_attributes<float, 8, 4, false>();
  if (err != cudaSuccess) return -(int)err;
  return bf16 ? max_active_clusters(slstm_cluster_kernel<__nv_bfloat16, 8, 4, false>, cluster, threads, smem)
              : max_active_clusters(slstm_cluster_kernel<float, 8, 4, false>, cluster, threads, smem);
}

}  // extern "C"
