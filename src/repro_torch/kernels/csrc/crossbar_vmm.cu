// Crossbar VMM datapath kernels for Hopper (sm_90a), plain C interface.
//
// Three __global__ kernels share one epilogue:
//
//   fast_kernel   replaces repro/kernels/crossbar_vmm.py::_fast_kernel
//                 (full-resolution ADC, exact):  sum_k x_k * w_k.
//   plane_kernel<false>  replaces crossbar_vmm.py::_vmm_kernel (the paper
//                 datapath): per row group, T input planes x S weight slices
//                 column partials, each put through the static per-(t, s)
//                 ADC tables (LSB round-half-up shift, MSB overflow detect),
//                 shift-added at bit t*dac_bits + s*cell_bits.
//   plane_kernel<true>   replaces repro/kernels/noisy_vmm.py::_noisy_kernel:
//                 the same, but each partial is an ADC sample of the analog
//                 sum against device-perturbed cells on the 2^-8 grid.
//   requantize    replaces crossbar_vmm.py::_requantize_block: remove the
//                 signed-weight bias 2^(wb-1) * sum(x), drop drop_lsb LSBs
//                 round-half-up, clamp to out_bits, force out_max where an
//                 overflow detect fired.
//
// Design.  The TPU kernels carry a two-limb int32 accumulator in VMEM across
// a sequential k grid axis and split operands into halves and slices so every
// dot stays exact in float32.  Here a lane owns one output column for BM input
// rows and keeps one int64 accumulator per row in registers; the warps of a
// block split the contraction (K ranges in fast_kernel, row groups in
// plane_kernel) and meet in shared memory for the epilogue.  Ragged M/N/K
// edges are masked, nothing is padded.
//
// What bounds them on this card.  fast_kernel: the bytes of the weight matrix
// (4 B per weight, read once, coalesced along N); at decode sizes the card is
// only filled if the contraction is split, hence the FAST_KS warps.  The
// plane kernels: integer instructions.  A column conversion is a dot product
// of a {0..2^dac-1} input plane with small cell values over <= 128 rows; both
// operands are held as packed bit-planes (32 rows a word), so the dot product
// is a few AND + __popc per 32 rows instead of 32 multiply-adds:
//     sum_r plane_r * cell_r = sum_{i<dac} sum_{j<PB} 2^(i+j) popc(xbit_i & cbit_j)
// with PB = cell_bits planes for ideal cells and cell_bits + 8 planes for the
// perturbed cells held as integers G = 256 * g_eff (so that the ADC sample
// floor(sum + 0.5) is (sum_G + 128) >> 8, exact in any order).  Input planes
// are packed with __ballot_sync as the codes are read; cell planes are packed
// by each lane for its own column, one slice at a time, into registers.  The
// same AND + popcount exists as a binary tensor-core MMA on this card; using
// it is the step that would bring these kernels near their bounds.
//
// Blocks of one column tile are neighbours in the grid (blockIdx.x walks the
// row tiles), so a weight tile read by one is found in L2 by the next.
//
// The kernels launch on the stream they are given, do not synchronise and
// allocate nothing.  Each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_TS 256      // n_iters * n_slices table entries
#define NO_DETECT (-128)
#define GEFF_FRAC_BITS 8
#define BN 32           // output columns per block: one per lane
#define FAST_KS 16      // warps of a fast_kernel block; each owns a K range
#define PW 8            // warps of a plane_kernel block; each owns row groups
#define XB_MAX 24       // input bit-planes kept per row (n_iters * dac_bits)
#define W32_MAX 4       // 32-row words per row group (rows <= 128)
#define FULL_MASK 0xffffffffu

struct VmmParams {
  int M, K, N;
  int rows, cell_bits, dac_bits, weight_bits, input_bits, out_bits, drop_lsb;
  int signed_weights, n_iters, n_slices, partial_max, skip_zero_planes;
  signed char shift[MAX_TS];   // [t * n_slices + s]: LSB shift g
  signed char detect[MAX_TS];  // [t * n_slices + s]: MSB detect bit, NO_DETECT if none
};

// Shared epilogue.  acc holds sum_k x_k * biased_w_k (possibly ADC-rounded).
__device__ __forceinline__ int requantize(long long acc, long long xsum, bool flag,
                                          const VmmParams& p) {
  long long out_min, out_max;
  if (p.signed_weights) {
    acc -= xsum << (p.weight_bits - 1);
    out_max = (1LL << (p.out_bits - 1)) - 1;
    out_min = -(1LL << (p.out_bits - 1));
  } else {
    out_max = (1LL << p.out_bits) - 1;
    out_min = 0;
  }
  // arithmetic shift of a signed value: floor((acc + half) / 2^d)
  long long y = (acc + (1LL << (p.drop_lsb - 1))) >> p.drop_lsb;
  y = y < out_min ? out_min : (y > out_max ? out_max : y);
  if (flag) y = out_max;  // the detect flag wins over the clip
  return (int)y;
}

// Full-resolution-ADC exact path.  With no per-conversion transform the
// biased accumulator minus the bias correction is just sum_k x_k * w_k, formed
// here directly in int64 (the TPU kernel's halves, slices and limbs exist only
// to stay exact in float32).  skip_zero_planes has nothing to skip here: the
// product is formed whole, not plane by plane.  Warp ks owns the K range
// [ks * kc, (ks + 1) * kc); x reads are warp-uniform broadcasts.
template <int BM>
__global__ void __launch_bounds__(BN * FAST_KS)
fast_kernel(const int* __restrict__ x, const int* __restrict__ w, int* __restrict__ out,
            const VmmParams p) {
  __shared__ long long red[FAST_KS][BM][BN];
  const int lane = threadIdx.x, ks = threadIdx.y;
  const int n = blockIdx.y * BN + lane;
  const int m0 = blockIdx.x * BM;
  const int mrows = min(BM, p.M - m0);
  const int kc = (p.K + FAST_KS - 1) / FAST_KS;
  const int k_end = min(p.K, (ks + 1) * kc);
  long long acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0;
  if (n < p.N) {
#pragma unroll 4
    for (int k = ks * kc; k < k_end; ++k) {
      const long long wv = w[(size_t)k * p.N + n];
#pragma unroll
      for (int i = 0; i < BM; ++i)
        if (i < mrows) acc[i] += (long long)x[(size_t)(m0 + i) * p.K + k] * wv;
    }
  }
#pragma unroll
  for (int i = 0; i < BM; ++i) red[ks][i][lane] = acc[i];
  __syncthreads();
  if (ks == 0 && n < p.N) {
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      if (i >= mrows) break;
      long long total = 0;
      for (int q = 0; q < FAST_KS; ++q) total += red[q][i][lane];
      // the bias is already out of the sum: requantize with sum(x) = 0
      out[(size_t)(m0 + i) * p.N + n] = requantize(total, 0, false, p);
    }
  }
}

// Paper datapath (NOISY = false: cells = int32 signed codes (K, N)) and
// device-perturbed datapath (NOISY = true: cells = float32 effective cell
// codes (S, K, N) in [0, 2^cell_bits - 1] on the 2^-8 grid).  Warp wy owns the
// row groups wy, wy + PW, ...; see the design note for the bit-plane form.
template <bool NOISY, int BM>
__global__ void __launch_bounds__(BN * PW)
plane_kernel(const int* __restrict__ x, const void* __restrict__ cells, int* __restrict__ out,
             const VmmParams p) {
  constexpr int PBMAX = NOISY ? 16 : 8;  // bit-planes of one slice's cell values
  __shared__ unsigned xb[PW][BM][XB_MAX][W32_MAX];  // packed input planes, per warp
  __shared__ long long red_acc[PW][BM][BN];
  __shared__ long long red_xsum[PW][BM];
  __shared__ int red_flag[PW][BM][BN];
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int n = blockIdx.y * BN + lane;
  const int m0 = blockIdx.x * BM;
  const int w32 = (p.rows + 31) / 32;
  const int pb = p.cell_bits + (NOISY ? GEFF_FRAC_BITS : 0);
  const int nxb = p.n_iters * p.dac_bits;
  const int dmask = (1 << p.dac_bits) - 1, cmask = (1 << p.cell_bits) - 1;
  const int bias = p.signed_weights ? (1 << (p.weight_bits - 1)) : 0;
  long long acc[BM], xsum[BM];
  bool flag[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) { acc[i] = 0; xsum[i] = 0; flag[i] = false; }

  const int n_groups = (p.K + p.rows - 1) / p.rows;
  for (int g = wy; g < n_groups; g += PW) {
    const int k0 = g * p.rows;
    const int kr = min(p.rows, p.K - k0);  // rows of a ragged last group

    // input codes of this group -> packed bit-planes, row sums, non-zero bits
    unsigned nz[BM];
    __syncwarp();
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      nz[i] = 0;
      for (int wi = 0; wi < w32; ++wi) {
        const int r = wi * 32 + lane, m = m0 + i;
        const int v = (m < p.M && r < kr) ? x[(size_t)m * p.K + k0 + r] : 0;
        xsum[i] += __reduce_add_sync(FULL_MASK, v);
        nz[i] |= __reduce_or_sync(FULL_MASK, (unsigned)v);
        for (int b = 0; b < nxb; ++b) {
          const unsigned word = __ballot_sync(FULL_MASK, (v >> b) & 1);
          if (lane == 0) xb[wy][i][b][wi] = word;
        }
      }
    }
    __syncwarp();

    for (int s = 0; s < p.n_slices; ++s) {
      // this lane's column of slice s -> packed bit-planes in registers
      unsigned cb[PBMAX][W32_MAX];
#pragma unroll
      for (int wi = 0; wi < W32_MAX; ++wi) {
#pragma unroll
        for (int j = 0; j < PBMAX; ++j) cb[j][wi] = 0;
        if (wi < w32 && n < p.N) {
          const int rmax = min(32, kr - wi * 32);
#pragma unroll 4
          for (int rr = 0; rr < rmax; ++rr) {
            const int r = wi * 32 + rr;
            unsigned c;
            if (NOISY) {
              const float gv = ((const float*)cells)[((size_t)s * p.K + k0 + r) * p.N + n];
              const int gi = __float2int_rn(gv * (float)(1 << GEFF_FRAC_BITS));
              c = (unsigned)min(max(gi, 0), (1 << pb) - 1);
            } else {
              const int wv = ((const int*)cells)[(size_t)(k0 + r) * p.N + n] + bias;
              c = (unsigned)((wv >> (s * p.cell_bits)) & cmask);
            }
#pragma unroll
            for (int j = 0; j < PBMAX; ++j) cb[j][wi] |= ((c >> j) & 1u) << rr;
          }
        }
      }

#pragma unroll
      for (int i = 0; i < BM; ++i) {
        for (int t = 0; t < p.n_iters; ++t) {
          const int tsh = t * p.dac_bits;
          // an all-zero input plane drives zero current into every bitline:
          // its conversions are 0 and change nothing (bit-identical skip)
          if (p.skip_zero_planes && ((nz[i] >> tsh) & dmask) == 0) continue;
          int sum = 0;
          for (int ii = 0; ii < p.dac_bits; ++ii) {
            unsigned xw[W32_MAX];
#pragma unroll
            for (int wi = 0; wi < W32_MAX; ++wi) xw[wi] = wi < w32 ? xb[wy][i][tsh + ii][wi] : 0u;
#pragma unroll
            for (int j = 0; j < PBMAX; ++j) {
              if (j < pb) {
                int cnt = 0;
#pragma unroll
                for (int wi = 0; wi < W32_MAX; ++wi) cnt += __popc(xw[wi] & cb[j][wi]);
                sum += cnt << (ii + j);
              }
            }
          }
          int q = sum;
          if (NOISY) {  // ADC sample: round half up, saturate
            q = (q + (1 << (GEFF_FRAC_BITS - 1))) >> GEFF_FRAC_BITS;
            q = min(q, p.partial_max);
          }
          const int gsh = p.shift[t * p.n_slices + s];
          const int d = p.detect[t * p.n_slices + s];
          if (gsh > 0) q = ((q + (1 << (gsh - 1))) >> gsh) << gsh;
          if (d != NO_DETECT && (q >> (d < 0 ? 0 : d)) > 0) flag[i] = true;
          acc[i] += (long long)q << (tsh + s * p.cell_bits);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < BM; ++i) {
    red_acc[wy][i][lane] = acc[i];
    red_flag[wy][i][lane] = flag[i];
    if (lane == 0) red_xsum[wy][i] = xsum[i];
  }
  __syncthreads();
  if (wy == 0 && n < p.N) {
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      if (m0 + i >= p.M) break;
      long long total = 0, xs = 0;
      bool fl = false;
      for (int q = 0; q < PW; ++q) {
        total += red_acc[q][i][lane];
        xs += red_xsum[q][i];
        fl = fl || red_flag[q][i][lane];
      }
      out[(size_t)(m0 + i) * p.N + n] = requantize(total, xs, fl, p);
    }
  }
}

// BM = 4 shares each packed cell column among four input rows; at small
// grids BM = 1 gives the card four times the blocks instead.
static bool wide_rows(const VmmParams& p) {
  return p.M >= 4 && (long long)((p.M + 3) / 4) * ((p.N + BN - 1) / BN) >= 132;
}

template <bool NOISY, int BM>
static int launch_plane(const void* x, const void* cells, void* out, const VmmParams& p,
                        cudaStream_t stream) {
  dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN), block(BN, PW);
  plane_kernel<NOISY, BM><<<grid, block, 0, stream>>>((const int*)x, cells, (int*)out, p);
  return (int)cudaGetLastError();
}

// The weight matrix is the traffic: BM input rows share each weight read.
template <int BM>
static int launch_fast(const void* x, const void* w, void* out, const VmmParams& p,
                       cudaStream_t stream) {
  dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN), block(BN, FAST_KS);
  fast_kernel<BM><<<grid, block, 0, stream>>>((const int*)x, (const int*)w, (int*)out, p);
  return (int)cudaGetLastError();
}

extern "C" {

// x (M, K) int32 codes, w (K, N) int32 codes, out (M, N) int32; all contiguous
// device pointers.  p is a host pointer.
int crossbar_vmm_fast(const void* x, const void* w, void* out, const VmmParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (p->M == 1) return launch_fast<1>(x, w, out, *p, st);
  if (p->M <= 4) return launch_fast<4>(x, w, out, *p, st);
  return launch_fast<8>(x, w, out, *p, st);
}

int crossbar_vmm_planes(const void* x, const void* w, void* out, const VmmParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return wide_rows(*p) ? launch_plane<false, 4>(x, w, out, *p, st)
                       : launch_plane<false, 1>(x, w, out, *p, st);
}

// g_eff (S, K, N) float32 effective cell codes in [0, 2^cell_bits - 1] on the
// 2^-8 grid.
int noisy_vmm_planes(const void* x, const void* g_eff, void* out, const VmmParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return wide_rows(*p) ? launch_plane<true, 4>(x, g_eff, out, *p, st)
                       : launch_plane<true, 1>(x, g_eff, out, *p, st);
}

}  // extern "C"
