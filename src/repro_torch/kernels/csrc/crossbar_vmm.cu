// Crossbar VMM datapath kernels for Hopper (sm_90a), plain C interface.
//
// Three __global__ kernels share one epilogue:
//
//   fast_kernel   replaces repro/kernels/crossbar_vmm.py::_fast_kernel (:190)
//                 with _requantize_block (:149): the full-resolution-ADC
//                 exact path, sum_k x_k * (w_k + bias), on int8 tensor cores.
//   paper_mma_kernel  replaces crossbar_vmm.py::_vmm_kernel (:78) with
//                 _schedule_tables (:55), the paper datapath: per row group,
//                 T input digits x S cell slices of w + bias give exact
//                 column partials, each put through the static per-(t, s)
//                 ADC tables (LSB round-half-up shift, MSB overflow detect)
//                 and shift-added at bit t*dac_bits + s*cell_bits.
//   noisy_mma_kernel  replaces repro/kernels/noisy_vmm.py::_noisy_kernel
//                 (:52): the same, but each partial is an ADC sample of the
//                 analog sum against device-perturbed cells on the 2^-8
//                 grid.  The two are one pipeline, mma_vmm<PAPER>, on int8
//                 tensor cores; they differ only in their cell source.
//   requantize    replaces crossbar_vmm.py::_requantize_block: remove the
//                 signed-weight bias 2^(wb-1) * sum(x), drop drop_lsb LSBs
//                 round-half-up, clamp to out_bits, force out_max where an
//                 overflow detect fired.
//
// fast_kernel.  What bounds it: the HBM bytes of the (K, N) int32 weight
// codes, read once at their stored width (4 B a weight, twice the 16-bit
// width chip_smoke.py's bound_ms charges); its int8 tensor-core operations
// take a fraction of the byte time even at M = 64.  What the design does
// about it:
//  * A block owns a column tile and all its input rows (up to 8 at decode,
//    M <= 8; 32 in prefill), so each weight is read from HBM once per call,
//    not once per row tile; where a call has more rows, the blocks of one
//    column tile are neighbours in the grid and L2 serves the repeats.
//  * It walks K in chunks.  The int32 w chunk and the int32 x chunk of all
//    its rows are staged in shared memory with cp.async (16 B a thread
//    where rows are 16 B aligned, 4 B otherwise).  FastDecode: 32 columns,
//    128-row chunks, 3 staged; FastPrefill: 64 columns (x is re-read once
//    per 64 columns), 64-row chunks, 2 staged, 3 blocks an SM.
//  * Each landed chunk is split into unsigned byte planes, x = 256 xh + xl
//    and wb = w + bias = 256 wh + wl (wb lies in [0, 2^16)), in 16-deep k
//    steps, while the warps multiply the planes of the chunk before (two
//    plane sets, one barrier a chunk).  x is row-major; w is k-contiguous
//    per column (wmma matrix_b col_major).  That departs from the row-major
//    w that needs no transpose: on the card a row-major u8 matrix_b compiles
//    to a byte load per element (16 LDS.U8 and their packing a fragment),
//    the k-contiguous one to ldmatrix, and the transpose is free, as each
//    thread splits a 4 x 4 block of w into bytes anyway.
//  * The warps issue nvcuda::wmma u8 x u8 -> s32 products hh, hl, lh, ll on
//    the tensor cores (m8n32k16 at decode, m16n16k16 in prefill); a high
//    plane is skipped where input_bits or weight_bits <= 8.  Warps split the
//    (row tile, column tile) pairs and, where there are fewer pairs than
//    warps, the k steps of a chunk (how a decode block fills its warps).
//  * A u8 product is at most 255^2 = 65025, so an int32 accumulator is
//    exact over FOLD_ROWS = 32768 rows (65025 * 32768 < 2^31; 33025 is the
//    exact limit).  Every FOLD_ROWS rows of K, and at the end, each lane
//    folds its four fragments element by element into int64 sums
//    (hh << 16) + ((hl + lh) << 8) + ll.  The warps of a tile then add their
//    sums in shared memory, and each output goes to requantize with its
//    row's sum(x) (the TPU kernel's own bias form).
//  * Where the grid leaves room on the card (a decode call of a narrow
//    layer), K is split over up to FAST_MAX_SPLITS blocks of one
//    thread-block cluster: each block stores its int64 outputs and sums of
//    x into the shared memory of the block that writes them (distributed
//    shared memory), so a call stays one launch with no workspace in device
//    memory.  Remote stores, not remote loads: dependent remote loads made
//    that epilogue cost as much as the K loop.
//
// mma_vmm (paper_mma_kernel, noisy_mma_kernel).  What bounds them: the HBM
// bytes of the cells, read once per call at decode: K3's (K, N) int32 codes
// (4 B a weight, 0.0059 ms at 960 x 5120) and K4's float32 cells g_eff
// (S, K, N) (32 B a weight at S = 8, 0.047 ms), against their u8 products
// (K3: S, K4: 2 S per k step) and a per-partial epilogue.  What the design
// does about it:
//  * The digits are matrix A: one row per (input row m, digit t), m * T + t,
//    64 rows a block (MB = 64 / T input rows: 4 at the 16 one-bit digits of
//    the default spec, up to 16), values 0..2^dac_bits - 1 as u8.  A group
//    has at most 128 rows, so a u8 x u8 -> s32 sum of a row group stays
//    below 128 * 255 * 255 < 2^31: every chunk's sums are exact.
//  * Cell sources.  K3 (PAPER): the int32 codes of a row group are one chunk;
//    a multiplying warp adds the bias and splits the words it needs into
//    two byte planes once, then cuts each slice (wb >> s cell_bits) &
//    cell_mask out of them in registers (cut_bytes) and issues one
//    mma.m16n8k32 u8 a (row tile, k step, slice).  Its partials are exact
//    (at most partial_max): no sample, no saturation.  K4: the cells of one
//    (row group, slice) are a chunk; on the 2^-8 grid they are integers
//    G = rint(256 g) <= 255 * 256, held as two byte planes G = 256 Gh + Gl,
//    so p = sum_k digit_t(x_k) G_k = 256 (A Gh) + A Gl, and the ADC sample
//    floor(p / 256 + 0.5) = (p + 128) >> 8 = A Gh + ((A Gl + 128) >> 8),
//    exact in any order: two mma a (row tile, k step), then saturation at
//    partial_max.
//  * A block owns 32 columns and walks its chunks in order through a ring of
//    four stages.  One warp loads: it waits until a stage is free, has the
//    TMA copy the chunk into it (a 3-D tensor map over (S, K, N), or (1, K,
//    N) for the codes, 32 columns x rows, zero-filled past N and K, 128 B
//    swizzle; cp.async into the same layout where N is no multiple of 4 or
//    the operand is not 16 B aligned), and for the first chunk of a row group
//    builds A from x into the stage itself, in the byte order the mma
//    fragments want, while the copy is in flight: a lane takes 16 rows of
//    one input row, splits them into byte planes and cuts each digit out of
//    them into one 16-byte unit of A.  (A lane a word of A, a table lookup a
//    digit, kept the loading warp busy twice as long as the multiplying
//    warps at K3's one chunk a row group.)  Per-stage mbarriers (full,
//    empty) replace block-wide barriers, so no warp waits on another's round.
//  * Eight warps multiply, each 32 A rows (two m16 tiles, their A fragments
//    in registers for the chunks of a row group) x 8 columns (one n8 tile).
//    A warp reads the staged words it needs straight into B fragments, with
//    the k order inside a 32-row step permuted so that the loads are
//    conflict-free.  K3's warps hold a whole row group in registers and give
//    the stage back before they multiply.  Nothing accumulates across
//    chunks in the MMA: the s32 sums go straight to the epilogue in
//    registers, where the fragment layout says which (t, column) each sum
//    is: the (t, s) shift and detect from a table in shared memory, and the
//    shift-add, in int32 across the slices and row groups of the block where
//    that cannot overflow (every spec with cells of 2 bits or more, up to
//    128 row groups at the default spec), else into one int64 per output the
//    lane owns.  The chunk loop is compiled once per (int32 shift-add,
//    detect), so the epilogue decides neither per partial.  (Keeping the
//    int64 sums out of the loop freed the registers that two blocks an SM
//    leave, 96 a thread: no spills.)  After the last chunk the warps meet in
//    shared memory; a thread per output adds the T digit rows of its input
//    row and requantizes.
//  * skip_zero_planes: a warp whose rows have no non-zero digit in a row
//    group skips that group's products and epilogue (a zero partial changes
//    nothing, so the output is the same either way).
//  * Two blocks an SM (106 KB of shared memory each); a decode call of
//    960 x 5120 is 160 blocks, more than one wave of 132 SMs.  Where the
//    tiles leave the card idle (960 x 320: 10 blocks) K is split over the
//    blocks of a thread-block cluster, as for fast_kernel: each block walks
//    its share of the row groups and stores its sums into the shared memory
//    of the cluster's first block, which requantizes.
//
// Blocks of one column tile are neighbours in the grid (blockIdx.x walks the
// row tiles), so a weight tile read by one is found in L2 by the next.
//
// The kernels launch on the stream they are given, do not synchronise and
// allocate nothing.  Each launcher returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

#define MAX_TS 256      // n_iters * n_slices table entries
#define NO_DETECT (-128)
#define GEFF_FRAC_BITS 8
#define FAST_WARPS 8    // warps of a fast_kernel block
#define FAST_MAX_SPLITS 8  // blocks of a cluster that split K (portable cluster size)
#define FOLD_ROWS 32768 // rows of K an int32 byte-plane accumulator may sum
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

// ---------------------------------------------------------------------------
// fast_kernel (see the note at the top)
// ---------------------------------------------------------------------------

// A copy outside the operand stores zeros instead (the form with a source
// size of 0 zero-fills too, but measured slower on the card).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (valid)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else
    *(int4*)dst = make_int4(0, 0, 0, 0);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (valid)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  else
    *(int*)dst = 0;
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N_PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N_PENDING));
}

// Bytes 0 and 1 of four words, packed four to a word in order: the low and
// high byte planes of four 16-bit values.
__device__ __forceinline__ void split_bytes(unsigned a, unsigned b, unsigned c, unsigned d, unsigned& lo,
                                            unsigned& hi) {
  const unsigned ab = __byte_perm(a, b, 0x5140), cd = __byte_perm(c, d, 0x5140);
  lo = __byte_perm(ab, cd, 0x5410);
  hi = __byte_perm(ab, cd, 0x7632);
}

// One fast_kernel configuration: wmma shape WM x WN x 16, NB columns and up
// to MB input rows a block, KC rows of K a chunk, STAGES chunks staged,
// BLOCKS blocks an SM.
template <int WM_, int WN_, int NB_, int KC_, int MB_, int STAGES_, int BLOCKS_>
struct FastCfg {
  static constexpr int WM = WM_, WN = WN_, NB = NB_, KC = KC_, MB = MB_, STAGES = STAGES_;
  static constexpr int BLOCKS = BLOCKS_;    // blocks an SM holds (register budget)
  static constexpr int NT = NB / WN;        // column tiles of a block
  static constexpr int KSTEPS = KC / 16;    // wmma k steps of a chunk
  static constexpr int LPR = KC / 4;        // lanes converting one row of x
  static constexpr int W_RAW = KC * NB * 4;           // int32 w chunk (KC, NB)
  static constexpr int W_PLANE = KSTEPS * NB * 16;    // [k step][column][16 k]
  static constexpr int TILE = WM * WN;
  static constexpr int PART = FAST_WARPS * TILE * 8;  // an int64 tile a warp
  static constexpr int RED = MB * NB * 8;             // the block's int64 outputs
  static constexpr int E = MB * NB / (FAST_WARPS * 32);  // outputs a thread writes
  // one byte plane of x: [k step][row][16 k], +32 B a step against conflicts
  __host__ __device__ static constexpr int x_slab(int rows) { return rows * 16 + 32; }
  __host__ __device__ static constexpr int x_plane(int rows) { return KSTEPS * x_slab(rows); }
  __host__ __device__ static constexpr int stage(int rows) { return W_RAW + rows * KC * 4; }
  // a plane set: w low, w high, x low, x high; two sets (convert one, multiply the other)
  __host__ __device__ static constexpr int plane_set(int rows) { return 2 * W_PLANE + 2 * x_plane(rows); }
  // receive buffers of a K split: the other blocks' int64 outputs (a share
  // of RED from each) and their sums of x
  static constexpr int RECV = RED + FAST_MAX_SPLITS * 8, RECV_X = FAST_MAX_SPLITS * MB * 8;
  // shared memory in bytes (every part a multiple of 32 B); after the K
  // loop the stages hold the warps' int64 tiles and the plane sets the
  // receive buffers
  __host__ __device__ static constexpr int bytes(int rows) {
    return STAGES * stage(rows) + 2 * plane_set(rows) + TILE * 4 + MB * 8;
  }
  static_assert(PART <= STAGES * W_RAW, "the warps' tiles fit in the stages");
  static_assert(MB * NB % (FAST_WARPS * 32) == 0, "outputs split evenly over the threads");
  static_assert(MB / WM * NT <= FAST_WARPS, "a warp multiplies one tile");
  static_assert(FOLD_ROWS % KC == 0 && STAGES >= 2 && LPR >= 8 && 32 % LPR == 0, "chunking");
};
// decode (M <= 8): one m8n32 tile a block, deep staging; prefill: m16n16
// tiles, 64 columns and 32 rows a block, so that x is re-read once per 64
// columns and three blocks fit on an SM
using FastDecode = FastCfg<8, 32, 32, 128, 8, 3, 2>;
using FastPrefill = FastCfg<16, 16, 64, 64, 32, 2, 3>;

static_assert(65025LL * FOLD_ROWS < (1LL << 31), "an int32 byte-plane sum must stay exact");

__device__ __forceinline__ int lane_of(const int4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Exact path on the int8 tensor cores; grid (row blocks of MB, column tiles
// of NB, K splits), FAST_WARPS warps, the K splits of a tile in one cluster.
// Bit-identical to requantize(sum_k x * (w + bias), sum x) for codes of <= 16
// bits.
template <class C>
__global__ void __launch_bounds__(FAST_WARPS * 32, C::BLOCKS)
fast_kernel(const int* __restrict__ x, const int* __restrict__ w, int* __restrict__ out,
            const VmmParams p) {
  using namespace nvcuda;
  constexpr int WM = C::WM, WN = C::WN, BNC = C::NB, KC = C::KC, MB = C::MB, STAGES = C::STAGES;
  using Acc = wmma::fragment<wmma::accumulator, WM, WN, 16, int>;
  constexpr int NTHREADS = FAST_WARPS * 32;
  constexpr int NE = Acc::num_elements;  // accumulator elements a lane holds
  static_assert(C::RECV + C::RECV_X <= 2 * C::plane_set(WM), "the receive buffers fit in the plane sets");
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.y * BNC, m0 = blockIdx.x * MB;
  const int mrows = min(MB, p.M - m0);
  const int rows = (min(MB, p.M) + WM - 1) / WM * WM;  // layout, equal in every block
  unsigned char* planes = smem + STAGES * C::stage(rows);
  int* index = (int*)(planes + 2 * C::plane_set(rows));
  long long* xsum = (long long*)((unsigned char*)index + C::TILE * 4);
  long long* recv = (long long*)planes;  // after the K loop
  long long* recv_x = recv + C::RECV / 8;

  // this block's share of K: chunks [c0, c0 + nc)
  const int n_chunks = (p.K + KC - 1) / KC;
  const int cps = (n_chunks + gridDim.z - 1) / gridDim.z;
  const int c0 = blockIdx.z * cps, nc = max(0, min(n_chunks, c0 + cps) - c0);

  const bool vec_w = (p.N % 4 == 0) && ((uintptr_t)w % 16 == 0);
  const bool vec_x = (p.K % 4 == 0) && ((uintptr_t)x % 16 == 0);
  const bool hi_x = p.input_bits > 8, hi_w = p.weight_bits > 8;
  const unsigned x_mask = (1u << p.input_bits) - 1, w_mask = (1u << p.weight_bits) - 1;
  const int bias = p.signed_weights ? 1 << (p.weight_bits - 1) : 0;

  // warp -> (row tile ti, column tile tn) and a residue class ks of k steps
  const int mt = (mrows + WM - 1) / WM, T = mt * C::NT;
  const int kslices = max(1, FAST_WARPS / T);
  const int tile = warp % T, ks = warp / T;
  const bool active = ks < kslices;
  const int ti = tile / C::NT, tn = tile % C::NT;

  // issue the cp.asyncs of chunk c into stage s (ragged edges zero-filled)
  auto issue = [&](int c, int s) {
    const int k0 = c * KC;
    int* dw = (int*)(smem + s * C::stage(rows));
    int* dx = dw + KC * BNC;
    if (vec_w) {
      for (int q = tid; q < KC * BNC / 4; q += NTHREADS) {
        const int kk = q / (BNC / 4), cc = q % (BNC / 4) * 4;
        const bool ok = k0 + kk < p.K && n0 + cc < p.N;
        cp_async16(dw + kk * BNC + cc, ok ? w + (size_t)(k0 + kk) * p.N + n0 + cc : w, ok);
      }
    } else {
      for (int q = tid; q < KC * BNC; q += NTHREADS) {
        const int kk = q / BNC, cc = q % BNC;
        const bool ok = k0 + kk < p.K && n0 + cc < p.N;
        cp_async4(dw + q, ok ? w + (size_t)(k0 + kk) * p.N + n0 + cc : w, ok);
      }
    }
    if (vec_x) {
      for (int q = tid; q < mrows * (KC / 4); q += NTHREADS) {
        const int r = q / (KC / 4), kk = q % (KC / 4) * 4;
        const bool ok = k0 + kk < p.K;
        cp_async16(dx + r * KC + kk, ok ? x + (size_t)(m0 + r) * p.K + k0 + kk : x, ok);
      }
    } else {
      for (int q = tid; q < mrows * KC; q += NTHREADS) {
        const int r = q / KC, kk = q % KC;
        const bool ok = k0 + kk < p.K;
        cp_async4(dx + q, ok ? x + (size_t)(m0 + r) * p.K + k0 + kk : x, ok);
      }
    }
  };

  // split the chunk in stage s into the byte planes of set b; add each row's
  // sum(x).  The w planes are written k-contiguous ([k step][column][16 k],
  // matrix_b col_major), which wmma loads with ldmatrix; a row-major u8
  // matrix_b compiles to a byte load per element.  A thread transposes 4 x 4
  // blocks: rows 4g..4g+3, columns 4c..4c+3.
  auto convert = [&](int s, int b) {
    const int* dw = (const int*)(smem + s * C::stage(rows));
    const int* dx = dw + KC * BNC;
    unsigned char* wl = planes + b * C::plane_set(rows);
    unsigned char* wh = wl + C::W_PLANE;
    unsigned char* xl = wh + C::W_PLANE;
    unsigned char* xh = xl + C::x_plane(rows);
    for (int q = tid; q < KC * BNC / 16; q += NTHREADS) {
      const int c = q % (BNC / 4), g = q / (BNC / 4);
      int4 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = *(const int4*)(dw + (4 * g + i) * BNC + 4 * c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned lo, hi;
        split_bytes((lane_of(v[0], j) + bias) & w_mask, (lane_of(v[1], j) + bias) & w_mask,
                    (lane_of(v[2], j) + bias) & w_mask, (lane_of(v[3], j) + bias) & w_mask, lo, hi);
        const int off = g / 4 * (BNC * 16) + (4 * c + j) * 16 + g % 4 * 4;
        *(unsigned*)(wl + off) = lo;
        *(unsigned*)(wh + off) = hi;
      }
    }
    // LPR lanes take one row of x, 4 k each; a row stays with one warp
    constexpr int RPW = 32 / C::LPR;
    for (int r0 = warp * RPW; r0 < rows; r0 += FAST_WARPS * RPW) {
      const int r = r0 + lane / C::LPR, k4 = lane % C::LPR;
      const int4 v = r < mrows ? *(const int4*)(dx + r * KC + k4 * 4) : make_int4(0, 0, 0, 0);
      int rsum = v.x + v.y + v.z + v.w;
#pragma unroll
      for (int d = C::LPR / 2; d > 0; d >>= 1) rsum += __shfl_xor_sync(FULL_MASK, rsum, d);
      if (k4 == 0) xsum[r] += rsum;
      unsigned lo, hi;
      split_bytes(v.x & x_mask, v.y & x_mask, v.z & x_mask, v.w & x_mask, lo, hi);
      const int off = k4 / 4 * C::x_slab(rows) + r * 16 + k4 % 4 * 4;
      *(unsigned*)(xl + off) = lo;
      *(unsigned*)(xh + off) = hi;
    }
  };

  // acc[0..3] = hh, hl, lh, ll; accumulator fragments of one shape share
  // their element layout, so a lane folds them element by element
  Acc acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0);
  long long wide[NE];
#pragma unroll
  for (int i = 0; i < NE; ++i) wide[i] = 0;
  auto fold = [&]() {
#pragma unroll
    for (int i = 0; i < NE; ++i)
      wide[i] += ((long long)acc[0].x[i] << 16) + (((long long)acc[1].x[i] + acc[2].x[i]) << 8) +
                 acc[3].x[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0);
  };

  // the products of chunk c from plane set b
  auto multiply = [&](int c, int b) {
    const unsigned char* wl = planes + b * C::plane_set(rows);
    const unsigned char* wh = wl + C::W_PLANE;
    const unsigned char* xl = wh + C::W_PLANE;
    const unsigned char* xh = xl + C::x_plane(rows);
    const int steps = min(C::KSTEPS, (p.K - c * KC + 15) / 16);
    for (int j = ks; j < steps; j += kslices) {
      wmma::fragment<wmma::matrix_a, WM, WN, 16, unsigned char, wmma::row_major> a_lo, a_hi;
      wmma::fragment<wmma::matrix_b, WM, WN, 16, unsigned char, wmma::col_major> b_lo, b_hi;
      const int xa = j * C::x_slab(rows) + ti * WM * 16, wa = j * (BNC * 16) + tn * WN * 16;
      wmma::load_matrix_sync(a_lo, xl + xa, 16);
      wmma::load_matrix_sync(b_lo, wl + wa, 16);
      wmma::mma_sync(acc[3], a_lo, b_lo, acc[3]);
      if (hi_w) {
        wmma::load_matrix_sync(b_hi, wh + wa, 16);
        wmma::mma_sync(acc[2], a_lo, b_hi, acc[2]);
      }
      if (hi_x) {
        wmma::load_matrix_sync(a_hi, xh + xa, 16);
        wmma::mma_sync(acc[1], a_hi, b_lo, acc[1]);
        if (hi_w) wmma::mma_sync(acc[0], a_hi, b_hi, acc[0]);
      }
    }
  };

  if (tid < MB) xsum[tid] = 0;
  for (int q = tid; q < C::TILE; q += NTHREADS) index[q] = q;
  // chunk j is cp.async group j: STAGES groups here, one a round from round 0
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < nc) issue(c0 + s, s);
    cp_async_commit();
  }
  // round i converts chunk i + 1 while the warps multiply chunk i: one
  // barrier a chunk.  A stage is refilled in the round after its conversion,
  // a plane set rewritten in the round after its products.
  for (int i = -1; i < nc; ++i) {
    // chunk i + 1 has landed: groups 0..i+1 of STAGES + max(i, 0) committed
    if (i < 0)
      cp_async_wait<STAGES - 1>();
    else
      cp_async_wait<STAGES - 2>();
    __syncthreads();  // ... for every thread; the last round is done
    if (i + 1 < nc) convert((i + 1) % STAGES, (i + 1) & 1);
    if (i >= 0) {
      if (i + STAGES < nc) issue(c0 + i + STAGES, i % STAGES);
      cp_async_commit();
      if (active) {
        multiply(c0 + i, i & 1);
        if ((i + 1) % (FOLD_ROWS / KC) == 0) fold();
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages and plane sets are free
  // blocks of a K split write each other's plane sets once all have left
  // their K loops: arrive here, wait before the first remote store
  if (gridDim.z > 1) asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");

  // the warps of one tile meet: each lane puts its int64 sums at their place
  // in the tile (read off a fragment of indices), then a thread adds the
  // k residue classes of its outputs
  long long* part = (long long*)smem;
  if (active) {
    fold();
    Acc pos;
    wmma::load_matrix_sync(pos, index, WN, wmma::mem_row_major);
#pragma unroll
    for (int i = 0; i < NE; ++i) part[warp * C::TILE + pos.x[i]] = wide[i];
  }
  __syncthreads();
  long long total[C::E];
#pragma unroll
  for (int e = 0; e < C::E; ++e) {
    const int o = tid + e * NTHREADS, r = o / BNC, c = o % BNC;
    total[e] = 0;
    if (r < mrows) {
      const int t = r / WM * C::NT + c / WN, at = r % WM * WN + c % WN;
      for (int k = 0; k < kslices; ++k) total[e] += part[(t + k * T) * C::TILE + at];
    }
  }
  if (gridDim.z == 1) {
#pragma unroll
    for (int e = 0; e < C::E; ++e) {
      const int o = tid + e * NTHREADS, r = o / BNC, c = o % BNC;
      if (r < mrows && n0 + c < p.N)
        out[(size_t)(m0 + r) * p.N + n0 + c] = requantize(total[e], xsum[r], false, p);
    }
    return;
  }
  // the K splits of this tile are the blocks of one cluster.  Output o is
  // written by block o % nb: every block stores its sum for o and its sums
  // of x into that block's receive buffers (distributed shared memory;
  // stores, so no block waits on a remote load), then each block adds up
  // what it received
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned nb = cluster.num_blocks(), rank = cluster.block_rank();
  const int slots = (MB * BNC + nb - 1) / nb;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int e = 0; e < C::E; ++e) {
    const int o = tid + e * NTHREADS;
    if (o / BNC < mrows) cluster.map_shared_rank(recv, o % nb)[rank * slots + o / nb] = total[e];
  }
  for (int q = tid; q < (int)nb * mrows; q += NTHREADS)
    cluster.map_shared_rank(recv_x, q / mrows)[rank * MB + q % mrows] = xsum[q % mrows];
  cluster.sync();
#pragma unroll
  for (int e = 0; e < C::E; ++e) {
    const int o = tid + e * NTHREADS, r = o / BNC, c = o % BNC;
    if (o % nb == rank && r < mrows && n0 + c < p.N) {
      long long sum = 0, xs = 0;
#pragma unroll
      for (unsigned q = 0; q < FAST_MAX_SPLITS; ++q) {
        if (q < nb) {
          sum += recv[q * slots + o / nb];
          xs += recv_x[q * MB + r];
        }
      }
      out[(size_t)(m0 + r) * p.N + n0 + c] = requantize(sum, xs, false, p);
    }
  }
}

// ---------------------------------------------------------------------------
// paper_mma_kernel (K3) and noisy_mma_kernel (K4): one pipeline, mma_vmm<PAPER>
// (see the note at the top)
// ---------------------------------------------------------------------------

#define NM_NB 32         // output columns a block
#define NM_RA 64         // rows of the digit matrix A a block: (input row m, digit t) as m * T + t
#define NM_MB 16         // input rows a block at most
#define NM_KR 128        // k rows a stage holds (the largest row group)
#define NM_CONSUMERS 8   // warps that multiply; one more warp loads the stages
#define NM_THREADS ((NM_CONSUMERS + 1) * 32)
#define NM_STAGES 4
#define NM_LDA 144       // bytes a row of A: 4 k steps of 32 + 16, so fragment loads are conflict-free
#define NM_MAX_CUTS 16   // digits (n_iters) or slices (n_slices) of a code of <= 16 bits

constexpr int NM_CELLS = NM_KR * NM_NB * 4;  // 4-byte cells of a chunk: 128-B rows, 16-B units swizzled
constexpr int NM_APLANE = NM_RA * NM_LDA;    // a row group's digits, [A row][k step][fragment order]
constexpr int NM_RED = NM_RA * NM_NB * 9;    // int64 sums + flag bytes after the loop
constexpr int NM_RED_ALIGNED = (NM_RED + 127) / 128 * 128;
// a K split's receive buffers in rank 0: sums, sums of x, flags of every rank
constexpr int NM_RECV = FAST_MAX_SPLITS * (NM_MB * NM_NB * 9 + NM_MB * 8);
constexpr int NM_SMEM =
    1024 + NM_STAGES * (NM_CELLS + NM_APLANE) + 2 * NM_STAGES * 8 + NM_MB * 8 + (MAX_TS + 2 * NM_MAX_CUTS) * 16;
static_assert(NM_CELLS % 1024 == 0, "cell stages keep the 1024 B alignment of the 128 B swizzle");
static_assert(NM_RED_ALIGNED + NM_RECV <= NM_STAGES * NM_CELLS, "the epilogue's sums fit in the cell stages");
static_assert(2 * (NM_SMEM + 1024) <= 233472, "two blocks fit on an SM");
static_assert(NM_RA == 32 * (NM_CONSUMERS / 4) && NM_NB == 8 * 4, "a warp owns 32 A rows x 8 columns");
// a column partial of one row group is at most 128 * 255 * 255 < 2^31 on
// any byte plane: the s32 sums of one chunk are exact
static_assert(NM_KR * 255LL * 255LL < (1LL << 31), "an s32 chunk sum must stay exact");

// D += A (16 x 32 u8, row) * B (32 x 8 u8, col), s32 accumulators
__device__ __forceinline__ void mma_u8(int (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// raise the bytes the current phase waits for (no arrival)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// order this thread's generic shared-memory accesses before later async-proxy
// (TMA) writes to the same memory
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one arrival on bar once this thread's earlier cp.asyncs have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// box {c0.., c1.., c2} of a 3-D tensor map into shared memory; completes bytes on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, "
      "%4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// G = rint(256 g) in the low 16 bits: g * 256 + 1.5 * 2^23 rounds to an
// integer in the mantissa (cells lie in [0, 2^cell_bits - 1], G < 2^16)
__device__ __forceinline__ unsigned grid_code(float g) {
  return __float_as_uint(fmaf(g, (float)(1 << GEFF_FRAC_BITS), 12582912.0f));
}

// Byte lane i of (lo, hi) holds a 16-bit value v_i as two planes, bits 0-7
// in lo and 8-15 in hi (split_bytes).  cut_of(sh, mask) describes the field
// (v >> sh) & mask, mask < 256, as {sh, the mask of its bits that come from
// lo, of those from hi}, each repeated in the four lanes; cut_bytes cuts it
// out of all four lanes at once.  Bits of v above 15 are 0, so a field that
// reaches past bit 15 keeps only the bits below it.
__device__ __forceinline__ int4 cut_of(int sh, unsigned mask) {
  if (sh >= 16) return make_int4(0, 0, 0, 0);
  mask &= (1u << (16 - sh)) - 1;
  const unsigned from_lo = sh < 8 ? mask & ((1u << (8 - sh)) - 1) : 0u;
  return make_int4(sh, (int)(from_lo * 0x01010101u), (int)((mask ^ from_lo) * 0x01010101u), 0);
}

__device__ __forceinline__ unsigned cut_lo(unsigned lo, const int4& c) { return (lo >> c.x) & (unsigned)c.y; }
__device__ __forceinline__ unsigned cut_hi(unsigned hi, const int4& c) { return (hi >> (c.x - 8)) & (unsigned)c.z; }
// the field straddles the planes: bits below 8 - sh from lo, the rest from hi
__device__ __forceinline__ unsigned cut_both(unsigned lo, unsigned hi, const int4& c) {
  return ((lo >> c.x) & (unsigned)c.y) | ((hi << (8 - c.x)) & (unsigned)c.z);
}
__device__ __forceinline__ unsigned cut_bytes(unsigned lo, unsigned hi, const int4& c) {
  if (c.z == 0) return cut_lo(lo, c);
  if (c.y == 0) return cut_hi(hi, c);
  return cut_both(lo, hi, c);
}

// a compile-time choice handed to a generic lambda
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Grid (row blocks of MB input rows, column tiles of NM_NB, K splits);
// NM_CONSUMERS warps multiply, warp NM_CONSUMERS loads.  PAPER: cells are
// the (K, N) int32 codes and a chunk is a row group; else cells are the
// (S, K, N) float32 effective cells and chunk c is (row group c / S, slice
// c % S).  Stage st holds a chunk as 128 rows of 32 4-byte cells, the 16-B
// units of row r at unit ^ (r & 7) (the tensor map's 128 B swizzle), and,
// for the first chunk of a row group, the group's digit matrix A, which the
// loading warp builds from x.  The cells come in by TMA where use_tma, else
// by cp.async into the same layout.
//
// The k order inside a 32-row step is permuted (the sum does not care):
// byte i of the fragment registers b0, a0, a1 is physical row 8 (i >> 1) +
// 2 tig + (i & 1) of the step, of b1, a2, a3 the same + 16.  Then for each
// i the 32 lanes of a warp read 32 different banks of the swizzled cells.
template <bool PAPER>
__device__ __forceinline__ void mma_vmm(const int* __restrict__ x, const unsigned* __restrict__ cells_g,
                                        int* __restrict__ out, const VmmParams& p, const CUtensorMap* cells_map,
                                        const int use_tma) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* aplanes = smem + NM_STAGES * NM_CELLS;
  uint64_t* full = (uint64_t*)(aplanes + NM_STAGES * NM_APLANE);  // a stage is loaded
  uint64_t* empty = full + NM_STAGES;                              // every consumer warp is done with it
  long long* xsum = (long long*)(empty + NM_STAGES);
  int4* table = (int4*)(xsum + NM_MB);  // [s][t]: round-half-up add, keep mask, detect limit
  int4* xcut = table + MAX_TS;          // [t]: digit t of x (cut_of)
  int4* wcut = xcut + NM_MAX_CUTS;      // [s]: slice s of w + bias (PAPER)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int T = p.n_iters, S = p.n_slices, dac = p.dac_bits;
  const int CPG = PAPER ? 1 : S;  // chunks a row group
  const int MB = min(NM_MB, NM_RA / T);
  const int m0 = blockIdx.x * MB, n0 = blockIdx.y * NM_NB;
  const int mrows = min(MB, p.M - m0);
  // this block's row groups [g_begin, g_end): a K split puts the blocks of a
  // tile in one cluster (rank blockIdx.z)
  const int n_groups = (p.K + p.rows - 1) / p.rows, gps = (n_groups + gridDim.z - 1) / gridDim.z;
  const int g_begin = blockIdx.z * gps, g_end = min(n_groups, g_begin + gps);
  const int nc = (g_end - g_begin) * CPG;
  const int box_rows = p.rows;  // rows of a stage the loads write; the rest stay 0

  // the shift-add over the slices of this block's row groups runs in int32
  // where it cannot overflow (a rounded partial is below 2 * partial_max);
  // the digit shift t * dac_bits is applied in int64 after the loop
  long long bound = 0;
  for (int q = 0; q < S; ++q) bound += (2LL * p.partial_max) << (q * p.cell_bits);
  const bool narrow = bound < (1LL << 31) / max(1, g_end - g_begin);

  bool detects = false;
  for (int q = tid; q < T * S; q += NM_THREADS) {  // q = t * S + s -> table[s * T + t]
    const int gsh = max((int)p.shift[q], 0), d = p.detect[q];
    table[q % S * T + q / S] = make_int4(gsh > 0 ? 1 << (gsh - 1) : 0, ~((1 << gsh) - 1),
                                         (d == NO_DETECT || d >= 31) ? 0x7fffffff : 1 << max(d, 0), 0);
    detects = detects || d != NO_DETECT;
  }
  if (tid < T) xcut[tid] = cut_of(tid * dac, (1u << dac) - 1);
  if (PAPER && tid >= 32 && tid - 32 < S) wcut[tid - 32] = cut_of((tid - 32) * p.cell_bits, (1u << p.cell_bits) - 1);
  for (int q = tid; q < NM_STAGES * (NM_KR - box_rows) * (NM_NB / 4); q += NM_THREADS) {
    const int st = q / ((NM_KR - box_rows) * (NM_NB / 4)), r = q % ((NM_KR - box_rows) * (NM_NB / 4));
    *(int4*)(smem + st * NM_CELLS + box_rows * 128 + r * 16) = make_int4(0, 0, 0, 0);
  }
  // rows of A past MB * T are never written: zero them once
  for (int q = tid; q < NM_STAGES * (NM_RA - MB * T) * (NM_LDA / 16); q += NM_THREADS) {
    const int st = q / ((NM_RA - MB * T) * (NM_LDA / 16)), r = q % ((NM_RA - MB * T) * (NM_LDA / 16));
    *(int4*)(aplanes + st * NM_APLANE + MB * T * NM_LDA + r * 16) = make_int4(0, 0, 0, 0);
  }
  if (tid < NM_MB) xsum[tid] = 0;
  if (tid == 0) {
    for (int st = 0; st < NM_STAGES; ++st) {
      // the loading warp's lanes arrive after their stores of A (and, without
      // TMA, once more as their cp.asyncs land)
      mbar_init(&full[st], use_tma ? 32 : 64);
      mbar_init(&empty[st], NM_CONSUMERS);
    }
    mbar_fence_init();
  }
  const bool has_detect = __syncthreads_or(detects);

  // a multiplying warp's output sums: int64 per (row tile, fragment element), detect flags
  long long wide[2][4];
  unsigned flags = 0;
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int e = 0; e < 4; ++e) wide[rt][e] = 0;
  const int j = warp & 3, h = warp >> 2;

  if (warp == NM_CONSUMERS) {
    // ---- the loading warp ----
    const unsigned xmask = (1u << p.input_bits) - 1;
    const bool vec_x = p.K % 4 == 0 && (uintptr_t)x % 16 == 0;
    // dac_bits of 1, 2, 4 or 8: digit t is (plane >> (t dac % 8)) & dac_mask
    // of one byte plane (t dac < 16: input codes have at most 16 bits)
    const bool byte_digits = 8 % dac == 0;
    const unsigned drep = ((1u << dac) - 1) * 0x01010101u;
    int g = g_begin, s = 0, st = 0;
    unsigned phase = 0;
    for (int c = 0; c < nc; ++c) {
      if (c >= NM_STAGES) mbar_wait(&empty[st], phase ^ 1);
      const int k0 = g * p.rows, kr = min(p.rows, p.K - k0);
      unsigned char* cells = smem + st * NM_CELLS;
      if (use_tma) {
        if (lane == 0) {
          mbar_expect_tx(&full[st], box_rows * NM_NB * 4);
          tma_load_3d(cells, cells_map, n0, k0, s, &full[st]);
        }
      } else {
        const unsigned* src = cells_g + ((size_t)s * p.K + k0) * p.N + n0;
        for (int q = lane; q < box_rows * NM_NB; q += 32) {
          const int kk = q >> 5, cc = q & 31;
          const bool ok = kk < kr && n0 + cc < p.N;
          cp_async4(cells + kk * 128 + ((((cc >> 2) ^ (kk & 7)) << 4) | ((cc & 3) << 2)),
                    ok ? src + (size_t)kk * p.N + cc : cells_g, ok);
        }
        cp_async_arrive(&full[st]);
      }
      if (s == 0) {
        // the group's digits, four input rows a pass.  Lane (row m, step,
        // half) takes the 16 rows 32 step + 16 half .. + 15 of input row m;
        // digit t of them is the 16-byte unit of A row m * T + t there, word
        // q holding rows 2q, 2q + 1, 2q + 8, 2q + 9 (the fragment order)
        const int lm = lane >> 3, kk = 32 * ((lane >> 1) & 3) + 16 * (lane & 1);
        unsigned char* A = aplanes + st * NM_APLANE + kk;
        const bool vec = vec_x && k0 % 4 == 0 && kk + 16 <= kr;
        for (int mp = 0; mp < MB; mp += 4) {
          const int m = mp + lm;
          const int* xr = x + (size_t)(m0 + m) * p.K + k0 + kk;
          unsigned v[16];
          if (m < mrows && vec) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int4 q = *(const int4*)(xr + 4 * i);
              v[4 * i] = q.x, v[4 * i + 1] = q.y, v[4 * i + 2] = q.z, v[4 * i + 3] = q.w;
            }
          } else {
#pragma unroll
            for (int i = 0; i < 16; ++i) v[i] = (m < mrows && kk + i < kr) ? (unsigned)xr[i] : 0u;
          }
          int sum = 0;
#pragma unroll
          for (int i = 0; i < 16; ++i) sum += (int)v[i];
#pragma unroll
          for (int d = 1; d < 8; d <<= 1) sum += __shfl_xor_sync(FULL_MASK, sum, d);
          if ((lane & 7) == 0 && m < mrows) xsum[m] += sum;
          unsigned lo[4], hi[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            split_bytes(v[2 * q] & xmask, v[2 * q + 1] & xmask, v[2 * q + 8] & xmask, v[2 * q + 9] & xmask, lo[q],
                        hi[q]);
          if (m < MB) {
            unsigned char* Am = A + m * T * NM_LDA;
            if (byte_digits) {  // a digit never straddles the byte planes
#pragma unroll 4
              for (int t = 0; t < T; ++t) {
                const int sh = t * dac;
                const unsigned* src = sh < 8 ? lo : hi;
                *(uint4*)(Am + t * NM_LDA) = make_uint4((src[0] >> (sh & 7)) & drep, (src[1] >> (sh & 7)) & drep,
                                                        (src[2] >> (sh & 7)) & drep, (src[3] >> (sh & 7)) & drep);
              }
            } else {
              for (int t = 0; t < T; ++t) {
                const int4 cut = xcut[t];
                *(uint4*)(Am + t * NM_LDA) = make_uint4(cut_bytes(lo[0], hi[0], cut), cut_bytes(lo[1], hi[1], cut),
                                                        cut_bytes(lo[2], hi[2], cut), cut_bytes(lo[3], hi[3], cut));
              }
            }
          }
        }
      }
      mbar_arrive(&full[st]);
      if (++s == CPG) { s = 0; ++g; }
      if (++st == NM_STAGES) { st = 0; phase ^= 1; }
    }
  } else {
    // ---- a multiplying warp: A rows 32 h .. 32 h + 31 (row tiles 2h, 2h + 1),
    // columns 8 j .. 8 j + 7; this lane's rows 32 h + 16 rt + gid + 8 e ----
    int row_t[2][2];
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int e = 0; e < 2; ++e) row_t[rt][e] = (32 * h + 16 * rt + gid + 8 * e) % T;
    const int n = 8 * j + gid;
    int cell_off[2];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int r = 2 * tig + b;  // physical row mod 8
      cell_off[b] = r * 128 + ((((n >> 2) ^ r)) << 4) + ((n & 3) << 2);
    }
    // word i of k step k of the staged chunk: physical row 32 k + 8 (i >> 1)
    // + 2 tig + (i & 1) of column n (fragment byte order)
    auto word = [&](const unsigned char* cells, int k, int i) {
      return *(const unsigned*)(cells + cell_off[i & 1] + (32 * k + 8 * (i >> 1)) * 128);
    };
    unsigned a[2][4][4];  // [row tile][k step][fragment register] of the current row group
    int part[2][4];       // sum over row groups and s of q_s << (s * cell_bits) (narrow)
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[rt][e] = 0;
    bool live = false;

    // the stage's reads are done: the next TMA into it may not pass them
    auto release = [&](int st) {
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    };
    // the table rows of this lane's outputs ([rt][e2]; slice sl at + sl * T)
    const int4* trow[2][2];
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) trow[rt][e2] = table + row_t[rt][e2];

    // the chunk loop, one copy per (int32 shift-add, detect): the epilogue
    // runs once per partial, so neither is decided there
    auto run = [&](auto narrow_c, auto detect_c) {
      constexpr bool NARROW = decltype(narrow_c)::value, DETECT = decltype(detect_c)::value;
      // the partials q of slice sl of this lane's outputs: the (t, s) tables
      // (round-half-up shift, detect), the shift-add
      auto take = [&](const int (&q)[2][4], int sl) {
        const int scb = sl * p.cell_bits;
#pragma unroll
        for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int4 tab = trow[rt][e2][sl * T];  // half, keep mask, detect limit
#pragma unroll
            for (int e1 = 0; e1 < 2; ++e1) {
              const int e = 2 * e2 + e1;
              const int v = (q[rt][e] + tab.x) & tab.y;
              if constexpr (DETECT) {
                if (v >= tab.z) flags |= 1u << (4 * rt + e);
              }
              if constexpr (NARROW)
                part[rt][e] += v << scb;
              else
                wide[rt][e] += (long long)v << (row_t[rt][e2] * dac + scb);
            }
          }
        }
      };
      int g = g_begin, s = 0, st = 0;
      unsigned phase = 0;
      for (int c = 0; c < nc; ++c) {
        mbar_wait(&full[st], phase);
        const unsigned char* cells = smem + st * NM_CELLS;
        if (s == 0) {
          const unsigned char* A = aplanes + st * NM_APLANE + (32 * h + gid) * NM_LDA + 4 * tig;
          bool any = false;
#pragma unroll
          for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
#pragma unroll
              for (int f = 0; f < 4; ++f) {
                // a0, a1, a2, a3: rows +0, +8, +0, +8; bytes +0, +0, +16, +16
                a[rt][k][f] = *(const unsigned*)(A + (16 * rt + 8 * (f & 1)) * NM_LDA + 32 * k + 16 * (f >> 1));
                any = any || a[rt][k][f] != 0;
              }
            }
          }
          live = __any_sync(FULL_MASK, any) || !p.skip_zero_planes;
        }
        if constexpr (PAPER) {
          // the row group's codes: wb = w + bias < 2^16 in two byte planes,
          // [k step][b0 / b1], then the stage goes back to the loading warp
          const unsigned bias = p.signed_weights ? 1u << (p.weight_bits - 1) : 0u;
          unsigned lo[4][2], hi[4][2];
          if (live) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
#pragma unroll
              for (int b = 0; b < 2; ++b)
                split_bytes(word(cells, k, 4 * b) + bias, word(cells, k, 4 * b + 1) + bias,
                            word(cells, k, 4 * b + 2) + bias, word(cells, k, 4 * b + 3) + bias, lo[k][b], hi[k][b]);
            }
          }
          release(st);
          if (live) {
            for (int sl = 0; sl < S; ++sl) {
              const int4 cut = wcut[sl];
              int acc[2][4] = {};
              // one u8 product a (row tile, k step); the slice's B fragments
              // cut from the byte planes (the branch is the same for the warp).
              // Rows past the end of K are 0 in A: every k step is multiplied
              auto products = [&](auto cut_planes) {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  const unsigned b0 = cut_planes(lo[k][0], hi[k][0]), b1 = cut_planes(lo[k][1], hi[k][1]);
#pragma unroll
                  for (int rt = 0; rt < 2; ++rt) mma_u8(acc[rt], a[rt][k], b0, b1);
                }
              };
              if (cut.z == 0)
                products([&](unsigned l, unsigned) { return cut_lo(l, cut); });
              else if (cut.y == 0)
                products([&](unsigned, unsigned u) { return cut_hi(u, cut); });
              else
                products([&](unsigned l, unsigned u) { return cut_both(l, u, cut); });
              take(acc, sl);  // exact partials: no sample, no saturation
            }
          }
        } else {
          if (live) {
            const int ksteps = (min(p.rows, p.K - g * p.rows) + 31) >> 5;
            int acc_lo[2][4], acc_hi[2][4];
#pragma unroll
            for (int rt = 0; rt < 2; ++rt)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc_lo[rt][e] = acc_hi[rt][e] = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (k < ksteps) {
                unsigned G[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) G[i] = grid_code(__uint_as_float(word(cells, k, i)));
                unsigned b0_lo, b0_hi, b1_lo, b1_hi;
                split_bytes(G[0], G[1], G[2], G[3], b0_lo, b0_hi);
                split_bytes(G[4], G[5], G[6], G[7], b1_lo, b1_hi);
#pragma unroll
                for (int rt = 0; rt < 2; ++rt) {
                  mma_u8(acc_lo[rt], a[rt][k], b0_lo, b1_lo);
                  mma_u8(acc_hi[rt], a[rt][k], b0_hi, b1_hi);
                }
              }
            }
            // ADC sample floor(sum g + 0.5) = (256 hi + lo + 128) >> 8 = hi +
            // ((lo + 128) >> 8), saturated at partial_max
            int q[2][4];
#pragma unroll
            for (int rt = 0; rt < 2; ++rt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                q[rt][e] = min(acc_hi[rt][e] + ((acc_lo[rt][e] + (1 << (GEFF_FRAC_BITS - 1))) >> GEFF_FRAC_BITS),
                               p.partial_max);
            take(q, s);
          }
          release(st);
        }
        if (++s == CPG) { s = 0; ++g; }
        if (++st == NM_STAGES) { st = 0; phase ^= 1; }
      }
      if constexpr (NARROW) {
#pragma unroll
        for (int rt = 0; rt < 2; ++rt)
#pragma unroll
          for (int e = 0; e < 4; ++e) wide[rt][e] = (long long)part[rt][e] << (row_t[rt][e >> 1] * dac);
      }
    };
    if (narrow) {
      if (has_detect)
        run(Flag<true>(), Flag<true>());
      else
        run(Flag<true>(), Flag<false>());
    } else {
      if (has_detect)
        run(Flag<false>(), Flag<true>());
      else
        run(Flag<false>(), Flag<false>());
    }
  }
  __syncthreads();  // every warp is past the stages: they hold the sums now
  long long* red = (long long*)smem;                   // [A row][column]
  unsigned char* red_flag = smem + NM_RA * NM_NB * 8;  // the same, a byte each
  if (warp < NM_CONSUMERS) {
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 32 * h + 16 * rt + gid + 8 * (e >> 1), col = 8 * j + 2 * tig + (e & 1);
        red[r * NM_NB + col] = wide[rt][e];
        red_flag[r * NM_NB + col] = (flags >> (4 * rt + e)) & 1;
      }
    }
  }
  __syncthreads();
  // a thread per output adds the T digit rows of its input row
  constexpr int PER = (NM_MB * NM_NB + NM_THREADS - 1) / NM_THREADS;  // outputs a thread adds
  long long total[PER];
  bool fl[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int o = tid + i * NM_THREADS, m = o / NM_NB, col = o % NM_NB;
    total[i] = 0;
    fl[i] = false;
    if (m < mrows) {
      for (int t = 0; t < T; ++t) {
        total[i] += red[(m * T + t) * NM_NB + col];
        fl[i] = fl[i] || red_flag[(m * T + t) * NM_NB + col];
      }
    }
  }
  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int o = tid + i * NM_THREADS, m = o / NM_NB, col = o % NM_NB;
      if (m < mrows && n0 + col < p.N)
        out[(size_t)(m0 + m) * p.N + n0 + col] = requantize(total[i], xsum[m], fl[i], p);
    }
    return;
  }
  // K split: every block stores its sums into rank 0's shared memory
  // (remote stores; past the local sums, in the cell stages every block has
  // left), then rank 0 adds them up and requantizes
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank(), nb = cluster.num_blocks();
  long long* recv = (long long*)(smem + NM_RED_ALIGNED);           // [rank][m * NM_NB + col]
  long long* recv_x = recv + FAST_MAX_SPLITS * NM_MB * NM_NB;       // [rank][m]
  unsigned char* recv_fl = (unsigned char*)(recv_x + FAST_MAX_SPLITS * NM_MB);  // [rank][m * NM_NB + col]
  long long* dst = cluster.map_shared_rank(recv, 0);
  long long* dst_x = cluster.map_shared_rank(recv_x, 0);
  unsigned char* dst_fl = cluster.map_shared_rank(recv_fl, 0);
  cluster.sync();  // rank 0 is past its stages
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int o = tid + i * NM_THREADS;
    if (o / NM_NB < mrows) {
      dst[rank * NM_MB * NM_NB + o] = total[i];
      dst_fl[rank * NM_MB * NM_NB + o] = fl[i];
    }
  }
  if (tid < mrows) dst_x[rank * NM_MB + tid] = xsum[tid];
  cluster.sync();
  if (rank != 0) return;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int o = tid + i * NM_THREADS, m = o / NM_NB, col = o % NM_NB;
    if (m < mrows && n0 + col < p.N) {
      long long sum = 0, xs = 0;
      bool f = false;
      for (unsigned q = 0; q < nb; ++q) {
        sum += recv[q * NM_MB * NM_NB + o];
        xs += recv_x[q * NM_MB + m];
        f = f || recv_fl[q * NM_MB * NM_NB + o];
      }
      out[(size_t)(m0 + m) * p.N + n0 + col] = requantize(sum, xs, f, p);
    }
  }
}

__global__ void __launch_bounds__(NM_THREADS, 2)
paper_mma_kernel(const int* __restrict__ x, const unsigned* __restrict__ codes, int* __restrict__ out,
                 const VmmParams p, const __grid_constant__ CUtensorMap cells_map, const int use_tma) {
  mma_vmm<true>(x, codes, out, p, &cells_map, use_tma);
}

__global__ void __launch_bounds__(NM_THREADS, 2)
noisy_mma_kernel(const int* __restrict__ x, const unsigned* __restrict__ g_eff, int* __restrict__ out,
                 const VmmParams p, const __grid_constant__ CUtensorMap cells_map, const int use_tma) {
  mma_vmm<false>(x, g_eff, out, p, &cells_map, use_tma);
}

// SMs of the current device (looked up once per device)
static int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 132;
  if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

// Launch on grid (tiles, splits) with dynamic shared memory; the splits of a
// tile form one thread-block cluster where there is more than one (a cluster
// launch without a split packs the blocks onto fewer SMs)
template <class... Params, class... Args>
static int launch_split(void (*kernel)(Params...), dim3 tiles, int splits, int threads, int smem,
                        cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles.x, tiles.y, splits);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiledFn)ptr;
  }
  return fn;
}

template <bool PAPER>
static int launch_mma(const void* x, const void* cells, void* out, const VmmParams& p, cudaStream_t stream) {
  const int MB = min(NM_MB, NM_RA / p.n_iters);
  CUtensorMap map;
  memset(&map, 0, sizeof map);
  const int use_tma = p.N % 4 == 0 && (uintptr_t)cells % 16 == 0;
  if (use_tma) {
    // (S, K, N) float32 cells or (1, K, N) int32 codes, N innermost; a box
    // is 32 columns x rows x 1 slice, zero-filled past N and K
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[3] = {(cuuint64_t)p.N, (cuuint64_t)p.K, (cuuint64_t)(PAPER ? 1 : p.n_slices)};
    const cuuint64_t strides[2] = {(cuuint64_t)p.N * 4, (cuuint64_t)p.K * p.N * 4};
    const cuuint32_t box[3] = {NM_NB, (cuuint32_t)p.rows, 1}, elem[3] = {1, 1, 1};
    const CUresult r = encode(&map, PAPER ? CU_TENSOR_MAP_DATA_TYPE_INT32 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                              const_cast<void*>(cells), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  }
  // where the tiles leave room on the card (two blocks an SM), K is split
  // over up to FAST_MAX_SPLITS blocks of a cluster, every one keeping a row
  // group at least
  const dim3 tiles((p.M + MB - 1) / MB, (p.N + NM_NB - 1) / NM_NB);
  const int n_groups = (p.K + p.rows - 1) / p.rows;
  int splits = max(1, min(min(2 * sm_count() / (int)(tiles.x * tiles.y), n_groups), FAST_MAX_SPLITS));
  const int gps = (n_groups + splits - 1) / splits;
  splits = (n_groups + gps - 1) / gps;
  return launch_split(PAPER ? paper_mma_kernel : noisy_mma_kernel, tiles, splits, NM_THREADS, NM_SMEM, stream,
                      (const int*)x, (const unsigned*)cells, (int*)out, p, map, use_tma);
}

// All rows of a block share each weight read; dynamic shared memory sized
// for the call's row capacity.  Where the row blocks x column tiles leave
// room on the card, K is split over up to FAST_MAX_SPLITS blocks of a
// cluster, as many as still fit in one wave, each keeping at least two
// chunks; otherwise the launch has no cluster (a cluster launch packs the
// blocks onto fewer SMs).
template <class C>
static int launch_fast(const void* x, const void* w, void* out, const VmmParams& p,
                       cudaStream_t stream) {
  const int rows = (min(C::MB, p.M) + C::WM - 1) / C::WM * C::WM;
  const int smem = C::bytes(rows);
  const dim3 tiles((p.M + C::MB - 1) / C::MB, (p.N + C::NB - 1) / C::NB);
  const int blocks = tiles.x * tiles.y, n_chunks = (p.K + C::KC - 1) / C::KC;
  int splits = max(1, min(min(C::BLOCKS * sm_count() / blocks, n_chunks / 2), FAST_MAX_SPLITS));
  const int cps = (n_chunks + splits - 1) / splits;
  splits = (n_chunks + cps - 1) / cps;  // no split without chunks
  return launch_split(fast_kernel<C>, tiles, splits, FAST_WARPS * 32, smem, stream, (const int*)x, (const int*)w,
                      (int*)out, p);
}

extern "C" {

// x (M, K) int32 codes, w (K, N) int32 codes, out (M, N) int32; all contiguous
// device pointers.  p is a host pointer.
int crossbar_vmm_fast(const void* x, const void* w, void* out, const VmmParams* p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return p->M <= 8 ? launch_fast<FastDecode>(x, w, out, *p, st) : launch_fast<FastPrefill>(x, w, out, *p, st);
}

// The paper datapath under the static ADC tables of p.
int crossbar_vmm_planes(const void* x, const void* w, void* out, const VmmParams* p, void* stream) {
  return launch_mma<true>(x, w, out, *p, (cudaStream_t)stream);
}

// g_eff (S, K, N) float32 effective cell codes in [0, 2^cell_bits - 1] on the
// 2^-8 grid.
int noisy_vmm_planes(const void* x, const void* g_eff, void* out, const VmmParams* p, void* stream) {
  return launch_mma<false>(x, g_eff, out, *p, (cudaStream_t)stream);
}

}  // extern "C"
