// Selective scan, forward: both directions in one launch, or one (sm_90a).
//
// scan_dual_fwd_kernel replaces the TPU kernel
// aum_tpu/ops/selective_scan.py:_fwd_kernel_dual in its default configuration
// (fused y-readout, per-step decay), in eval and, with saved chunk states, in
// the train forward. scan_dual_direct_fwd_kernel replaces
// _fwd_kernel_dual_direct (the opt-in behind AUM_SCAN_DIRECT=1): the same
// function with no staging of B/C (below); its plain version is the staged
// kernel's, selective_scan_dual_plain. scan_single_fwd_kernel replaces _fwd_kernel_z: one
// direction, chosen at run time, with the same saved states and, in its
// with_state form, a carried-in initial state and the final state out. Per
// direction, per (batch b, channel d), with dt = softplus(delta + bias):
//
//   x_t  = exp2(dt_t * (A[d, :] * log2 e)) * x_{t-1} + (dt_t * u_t) * B_t
//   y_t  = sum_n C_t[n] * x_t[n]
//   out  = (y_t + D[d] * u_t) * silu(z_t)          (cast to u's dtype)
//
// The forward direction walks t = 0 .. L-1, the reverse one t = L-1 .. 0.
//
// Where dt is formed. The saving forms (the grad path) and the stage form
// stream dt as the wrapper formed it (softplus in fp32, rounded to the
// stream dtype), as the TPU kernels take it. The eval forms (no saved
// states: the staged and direct dual kernels, the single-direction kernel
// as is and with_state; kDelta in scan_walk), which every forward with no
// grad to take launches, stream delta itself, the dt_proj product in the
// stream dtype, and form dt = softplus(delta + bias[d]) in fp32 in
// registers, once per element and direction, as each sub-chunk's deltas
// arrive (the bias added where given, the softplus where asked for), as
// the upstream CUDA kernel does: dt is never rounded. That takes the
// wrapper's fp32 pass over a (B, L, D) tensor (nine memory-bound
// elementwise kernels) off those paths, for about fifteen FP32-pipe and two
// SFU instructions per element and direction in the walk, against the 16
// states' exp2 and FMAs of each step. Given an activated dt, no bias and
// the softplus off, they compute the saving forms' function.
//
// Two opt-in forms of _fwd_kernel_dual, each its own kernel on the same walk:
// - scan_dual_fdt_fwd_kernel (AUM_SCAN_FUSE_DT=1, eval, no saved states)
//   takes dtr, the (batch, L, R) dt-rank columns of x_proj's output, the
//   dt_proj weight W (R, D) and the fp32 bias in dt's place, and forms
//   dt = softplus(sum_r dtr[t, r] W[r, d] + bias[d]) itself, in fp32 (the
//   products of the stream dtype's values, fp32 sums, then max(v, 0) +
//   log1p(exp(-|v|)) to a few ulp, once per element, not per state). dt is
//   never rounded to the stream dtype, as in the TPU kernel, and neither is
//   the product (the default's no-grad forms read it rounded, as delta): the
//   one place where this form's outputs differ from theirs. Each warp forms the
//   dt of its 32 channels for 16 steps at a time into a shared tile the walk
//   reads, a sub-chunk before the walk first reads it: in bf16 with
//   tensor-core products (mma.sync m16n8k16 on ldmatrix fragments, fp32
//   sums; a product of two bf16 values is exact in fp32, as in the TPU
//   kernel's fp32 dot), in fp32 with FMAs (no TF32). Its operands sit in
//   shared memory, so forming a tile reads no global memory: the block's W
//   slice (its channels x R) is copied once at the start, the dtr rows a
//   window of 64 steps at a time, with cp.async one chunk ahead into a ring
//   of two windows (scalar copies where the rows are not 16-byte aligned),
//   and the bias once. No (batch, L, D) dt tensor is read or exists.
// - scan_dual_stage_fwd_kernel (AUM_SCAN_BF16_STAGE=1, bf16 streams, eval
//   and saving) rounds to bf16 where the TPU kernel stages in bf16: the
//   decay is exp2(bf16(dt * bf16(log2 e)) * A) (a bf16 array times a Python
//   float is a bf16 product in JAX, the constant rounded to bf16 first:
//   1.4453125) and the input term bf16(dt * u) * B_t; the FMA chain stays
//   fp32. fp32 streams never take it.
// The walk starts from zero, or from x0[b, n, d] (fp32) with a carried-in
// state. With saved states (xb != null) the chain also writes its N states
// at the entry of every chunk of kChunk processed steps to xb[b, chunk, n, d]
// (fp32, coalesced over d): the states the backward (selective_scan_bwd.cu)
// restarts from; chunk 0's entry state is the starting state. With a final
// state (xfin != null) it writes the state after its last processed step
// (position 0 when reversed) to xfin[b, n, d].
//
// Design: one thread owns one (batch, channel, direction) chain and keeps its
// N <= 16 fp32 states and its A row in registers, so the state never
// touches memory. A block covers kThreads neighbouring channels of one batch
// row in one direction (grid = (ceil(D / kThreads), batch, directions)); its
// threads read u, dt, z and write out with neighbouring threads on
// neighbouring addresses. The walk goes in sub-chunks of kSub steps: the
// next sub-chunk's u, dt and z are loaded into registers while this one is
// walked, so no step waits on memory. B_t and C_t are the same for every
// channel of a row: the block stages a chunk of kChunk steps of them in
// shared memory (all of a thread's loads issued before the first barrier)
// and every thread reads them as broadcasts. The direct kernel does not
// stage them: every thread reads B_t and C_t straight from global memory at
// every step, in 16-byte vectors where the rows allow, broadcasts within a
// warp that L1 or the read-only path serves. A step per state is one
// multiply, one exp2 on the special-function unit (ex2.approx.ftz, with
// log2 e folded into A once), a multiply and two FMAs; the gate is a
// sigmoid from the SFU's exp2 and reciprocal. A CUDA loop runs exactly L
// steps, so unlike the TPU kernels (whose blocks overhang the array)
// nothing is masked. There is no chunk carry across blocks and no padding
// of N. All five kernels run one walk, scan_walk, so they cannot drift
// apart.
//
// What bounds it: per element of (batch, length, channel, state) and
// direction the chain does one exp2 and four FP32-pipe instructions. The
// special-function units do 16 exp2 per SM per clock, against 128 FP32
// lanes, so the exponentials outweigh both the FP32 work and the bytes moved
// (3 (B,L,D) reads and 1 (B,L,D) write per direction); moving a share of
// them to the FP32 pipe as polynomials would lower that floor by about a
// quarter (chip_smoke.py counts that split in its bound). On an H100 the
// kernels do not reach it: running 1 or 2 of every 8 states' exp2 as a
// degree-7 polynomial (as accurate as the SFU) was measured slower, so
// issue slots and latency, not the SFUs, hold them. Splitting a
// chain's N states over 2 or 4 lanes (as the backward does) was measured
// slower on an H100 at every batch: the per-step work that does not scale
// with N (loads, the gate, the shuffled sums of y) is then repeated on
// every lane. The available parallelism is batch * channels * directions
// chains, each a serial dependence over L; the registers (128-168 a
// thread, 3 or 4 blocks of 4 warps per SM) trade warps in flight for loads
// in flight. The fuse_dt form adds per element one product of rank terms
// (on the tensor cores in bf16: negligible against the scan) and one
// softplus (about fifteen FP32-pipe instructions and two SFU ones, once per
// element and direction, not per state), and reads a (B, L, R) dtr in place
// of the (B, L, D) dt. Its first design (mma fragments loaded from global
// memory by each warp at every tile, an expf/log1pf softplus) took 1.73x
// the default kernel's time on an H100 at the Fo-Bi bench shapes, the walk
// itself as fast as the default's: each tile's loads, products and softplus
// came on top. Hence the operands in shared memory, read as ldmatrix
// fragments, and the SFU softplus. Up to dt rank kWholeRank (400) the
// product loops over the rank in mma k-steps of 16 (zeros past it), and
// the W slice and the dtr ring are sized by the rank (dynamic shared
// memory, opted into above 48 KB), up to the 227 KB a block can hold in
// bf16. In fp32 the W slice and the ring together pass that at rank 209, and
// a lane reads only its own channel's W row: from there on (kWGlobal) W
// stays in global memory, each lane reading its row through L1, and only
// the ring is staged. Past kWholeRank (any rank: the TPU kernel pads R to a
// multiple of 128) a block cannot hold its W slice, so the windowed form
// (scan_dual_fdt_win_fwd_kernel, the same walk) forms the dt of a whole
// chunk of kChunk steps at the chunk's start, block-wide, over windows of
// kWinCols<T> rank columns: per window it stages the block's W slice's
// columns (bf16; fp32 keeps W in global memory as above) and the chunk's dtr
// rows' columns, and each warp adds the window's product to its channels'
// fp32 dt sums, kept in a (kChunk x channels) shared tile between windows;
// after the last window the softplus, once per element, as above. The
// windows are sized so that two blocks fit an SM (8 warps); the W slice is
// read again at every chunk, from L2.
//
// State sizes above 16 (any N, as the TPU kernels pad N to a multiple of 8
// and sum over it): the recurrence is independent per state, so the
// wrapper runs N as slices of kMaxN states (the last one ragged, masked as
// N < 16 is), each a launch of the same kernel from this source built
// ungated (AUM_SCAN_GATED=0, common.cuh: the library "selective_scan_sliced")
// on its own columns of B and C, its rows of A and its own saved and
// carried states. The ungated build writes the fp32 partial y_t = sum_n
// C_t[n] x_t[n] of its slice to an fp32 out and reads neither z nor D;
// scan_combine.cu sums the slices' partials in fp32, adds D u, applies the
// gate and rounds once, as the TPU kernel sums over its padded N in fp32 and
// casts once. Slices were chosen over several 16-state groups on one chain
// (lanes summing y by shuffles): they keep every walk, its registers and
// the backward's 4-lane layout as they are, and the gated build, which
// every N <= 16 takes, is this source unchanged. A scan without z (or D)
// takes the ungated build at any N, and the combine skips the gate.

#include <cstdint>
#include <type_traits>

#include "common.cuh"

// One direction's operands. Strides are in elements; the channel stride of
// every (B, L, D) or (B, L, N) stream is 1, so column slices of a wider
// matrix (the x/z halves of in_proj, the B/C columns of x_proj) need no copy.
struct ScanDir {
  const void* u;
  const void* dt;
  const void* z;
  const void* B;
  const void* C;
  const float* A;      // (D, N) fp32, contiguous
  const float* Dskip;  // (D,) fp32; unread (may be null) in the ungated build, as is z
  void* out;           // (batch, L, D), contiguous, u's dtype (fp32 partials ungated)
  float* xb;           // (batch, ceil(L / kChunk), N, D) fp32, or null
  const float* x0;     // (batch, N, D) fp32 starting state, or null (zero)
  float* xfin;         // (batch, N, D) fp32 final state, or null
  long long u_sb, u_sl;
  long long dt_sb, dt_sl;
  long long z_sb, z_sl;
  long long B_sb, B_sl;
  long long C_sb, C_sl;
  // The fuse_dt form only (dt unused): dtr (batch, L, rank) in the stream
  // dtype, rank stride 1; Wt, the dt_proj weight as (D, rank) in the stream
  // dtype, rank stride 1 (W's transpose: torch's dt_proj layout); bias (D,)
  // fp32.
  const void* dtr;
  const void* Wt;
  const float* bias;
  long long dtr_sb, dtr_sl;
  long long Wt_sd;
  int rank;
  // The eval forms read delta from dt and form dt = delta + bias (bias
  // (D,) fp32, or null: none), through the softplus where softplus != 0, in
  // fp32. The forms that stream the activated dt (saving, stage) take
  // neither.
  int softplus;
};

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;
constexpr int kMaxN = 16;
constexpr int kSub = 8;  // steps whose streams are loaded together, one sub-chunk ahead
// Blocks per SM the registers are capped for, each measured best on an
// H100: 4 (128 registers, a few bytes of spills) for the dual eval forward
// and the direct one, 3 (168) for the saving dual forward and the
// single-direction forward.
constexpr int kMinBlocks = 3;
constexpr int kMinBlocksWide = 4;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLog2eBf16 = 1.4453125f;  // log2 e rounded to bf16 (the stage form)
constexpr int kWarpSize = 32;
constexpr int kWarps = kThreads / kWarpSize;
constexpr int kDtRows = 16;    // steps per dt tile of the fuse_dt form: one mma's rows
// The fuse_dt form's largest dt rank whose W slice and dtr ring a block
// holds whole (in bf16; fp32 keeps W in global memory past 208): past it the
// windowed form runs.
constexpr int kWholeRank = 400;
// The fuse_dt form's ring of staged dtr rows: two windows of kChunk steps;
// processed step i sits in slot (i - kDtrLead) mod kDtrSlots, so that the
// window staged at the start of chunk c (steps c + kChunk + kDtrLead on)
// holds every row the tiles formed during chunk c + kChunk read.
constexpr int kDtrSlots = 2 * kChunk;
constexpr int kDtrLead = kDtRows;
static_assert(kChunk % kSub == 0, "chunks start on a sub-chunk");
static_assert(kDtRows % kSub == 0, "dt tiles start on a sub-chunk");
static_assert(kChunk % kDtRows == 0, "a tile's rows are consecutive slots of the ring");
static_assert(kMaxN * kChunk % kThreads == 0, "the staging loop has no remainder");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The reference's softplus, max(v, 0) + log1p(e) with e = exp(-|v|) in
// (0, 1], to a few ulp: e from the SFU's exp2 with the rounding error of
// |v| log2 e put back (a first-order term), and log1p(e) = 2 atanh(s), s =
// e / (2 + e) in (0, 1/3], as s times a series in s^2 up to s^12 / 13 (the
// first term left out is below 2^-26 of the sum). The fuse_dt form and the
// in-kernel dt run it once per (step, channel) and direction.
__device__ __forceinline__ float softplus(float v) {
  constexpr float kLog2eLo = 1.925963033500011e-08f;  // log2 e - kLog2e
  constexpr float kLn2 = 0.6931471805599453f;
  const float a = -fabsf(v);
  const float hi = a * kLog2e;
  const float lo = fmaf(a, kLog2e, -hi) + a * kLog2eLo;
  float e = aum::exp2_sfu(hi);
  e = fmaf(e, lo * kLn2, e);
  const float s = e * aum::rcp_sfu(2.0f + e);
  const float s2 = s * s;
  float q = 1.0f / 13.0f;
  q = fmaf(q, s2, 1.0f / 11.0f);
  q = fmaf(q, s2, 1.0f / 9.0f);
  q = fmaf(q, s2, 1.0f / 7.0f);
  q = fmaf(q, s2, 1.0f / 5.0f);
  q = fmaf(q, s2, 1.0f / 3.0f);
  q = fmaf(q, s2, 1.0f);
  return fmaf(2.0f * s, q, fmaxf(v, 0.0f));
}

// Row strides (elements) of the fuse_dt form's staged W and dtr rows. bf16:
// the rank padded with zeros to whole mma k-steps of 16, plus 8 (16 bytes),
// so rows are 16-byte aligned for ldmatrix and 8 consecutive rows fall on 8
// distinct 16-byte bank groups. fp32: W rows an odd number of words apart
// (a warp reads 32 channels' rows at one rank: 32 banks); dtr rows 16-byte
// aligned (their reads are broadcasts).
template <typename T>
__host__ __device__ constexpr int fold_w_stride(int rank) {
  return sizeof(T) == 2 ? (rank + 15) / 16 * 16 + 8 : rank | 1;
}
template <typename T>
__host__ __device__ constexpr int fold_dtr_stride(int rank) {
  return sizeof(T) == 2 ? (rank + 15) / 16 * 16 + 8 : (rank + 3) / 4 * 4;
}
// The fuse_dt kernel's dynamic shared memory (W slice and dtr ring) and its
// static shared memory (s_B, s_C, the dt tiles, the biases), in bytes.
template <typename T>
constexpr int fold_dyn_smem(int rank) {
  return (kThreads * fold_w_stride<T>(rank) + kDtrSlots * fold_dtr_stride<T>(rank)) *
         static_cast<int>(sizeof(T));
}
constexpr int kFdtStaticSmem =
    (2 * kChunk * kMaxN + kWarps * kDtRows * (kWarpSize + 1) + kThreads) * sizeof(float);
// The most shared memory (static and dynamic) a block takes without opting in.
constexpr int kDefaultSmem = 48 * 1024;
// The most a block can hold on an H100 (227 KB), opted in.
constexpr int kMaxSmem = 232448;
// Whether the fp32 form keeps W in global memory at `rank` (the W slice
// and the ring would not fit in a block's shared memory together).
constexpr bool fold_w_global(int rank, bool fp32) {
  return fp32 && kFdtStaticSmem + fold_dyn_smem<float>(rank) > kMaxSmem;
}
// The fuse_dt kernel's shared memory in all (static and dynamic) at `rank`.
constexpr int fold_smem(int rank, bool fp32) {
  return kFdtStaticSmem +
         (!fp32 ? fold_dyn_smem<__nv_bfloat16>(rank)
                : fold_w_global(rank, fp32) ? kDtrSlots * fold_dtr_stride<float>(rank) * 4
                                            : fold_dyn_smem<float>(rank));
}
static_assert(fold_smem(kWholeRank, false) <= kMaxSmem && fold_smem(kWholeRank, true) <= kMaxSmem,
              "both dtypes hold every rank up to kWholeRank whole");

// The windowed form (ranks past kWholeRank): its static shared memory (s_B,
// s_C, the chunk's dt sums, the biases), the row stride of its staged W and
// dtr windows (as fold_w_stride: bf16 rows padded for ldmatrix, fp32 rows
// 16-byte aligned), its rank columns per window (a multiple of the mma
// k-step: the largest that keeps a block within kWinSmem, two blocks an
// SM) and its dynamic shared memory (bf16: the W window and the dtr
// window; fp32: the dtr window alone).
constexpr int kDtcStride = kThreads + 4;  // the chunk's dt sums, [step][channel]
constexpr int kWinStaticSmem = (2 * kChunk * kMaxN + kChunk * kDtcStride + kThreads) * 4;
constexpr int kWinSmem = 112 * 1024;
template <typename T>
__host__ __device__ constexpr int win_stride(int cols) {
  return sizeof(T) == 2 ? cols + 8 : cols;
}
template <typename T>
__host__ __device__ constexpr int win_dyn_smem(int cols) {
  return (sizeof(T) == 2 ? kThreads + kChunk : kChunk) * win_stride<T>(cols) *
         static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int win_cols() {
  int cols = 16;
  while (kWinStaticSmem + win_dyn_smem<T>(cols + 16) <= kWinSmem) cols += 16;
  return cols;
}
template <typename T>
constexpr int kWinCols = win_cols<T>();
static_assert(kWinCols<__nv_bfloat16> < kWholeRank && kWinCols<float> < kWholeRank,
              "a windowed rank needs two windows or more");

// The fuse_dt form's shared operands: the block's W slice (kThreads channel
// rows of rank values), the dtr ring, the block's biases and each warp's dt
// tile (+1: fewer bank conflicts). With W in global memory (kWGlobal,
// fp32), W is the calling thread's own channel's row of it and w_stride 0.
template <typename T>
struct Fold {
  T* W;
  T* dtr;
  float* bias;
  float (*dt)[kDtRows][kWarpSize + 1];
  int w_stride, dtr_stride;
};

// The windowed form's shared operands: the W window (bf16: kThreads channel
// rows; fp32: W in global memory, W the calling thread's own channel's row
// of it), the dtr window (kChunk step rows), both win_stride apart, the
// block's biases and the chunk's dt sums.
template <typename T>
struct FoldWin {
  T* W;
  T* dtr;
  float* bias;
  float (*dt)[kDtcStride];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy `count` rows of `rank` elements, row r from src_row(r) to
// dst_row(r), with every thread of the block: as 16-byte cp.async where
// `vector` (every row's bytes and addresses 16-byte aligned; complete after
// cp_async_wait_all), else value by value.
template <typename T, typename Src, typename Dst>
__device__ __forceinline__ void stage_rows(Src src_row, Dst dst_row, int count, int rank,
                                           bool vector) {
  if (vector) {
    constexpr int kPer = 16 / sizeof(T);
    const int per_row = rank / kPer;
    for (int idx = threadIdx.x; idx < count * per_row; idx += kThreads) {
      const int r = idx / per_row, v = idx % per_row;
      cp_async16(dst_row(r) + v * kPer, src_row(r) + v * kPer);
    }
  } else {
    for (int idx = threadIdx.x; idx < count * rank; idx += kThreads) {
      const int r = idx / rank, k = idx % rank;
      dst_row(r)[k] = src_row(r)[k];
    }
  }
}

// Whether rows of `rank` elements at `base` with strides `s1`, `s2` (in
// elements) are all whole 16-byte vectors.
template <typename T>
__device__ __forceinline__ bool whole_rows16(const void* base, int rank, long long s1,
                                             long long s2) {
  constexpr int kPer = 16 / sizeof(T);
  return rank % kPer == 0 && aum::aligned16(base) && s1 % kPer == 0 && s2 % kPer == 0;
}

// One dt tile of the fuse_dt form: dt of the calling warp's kWarpSize
// channels at processed steps i0 .. i0 + kDtRows - 1 (i0 a multiple of
// kDtRows), from the staged W and dtr rows, into tile[row][channel]. Rows
// past the end were staged from the last step and channels past the last
// one from the last channel: their dt is never used. Every lane of the warp
// calls it.
template <typename T>
__device__ __forceinline__ void dt_tile(const Fold<T>& f, int rank, int i0,
                                        float (*tile)[kWarpSize + 1]);

// fp32: each lane forms its own channel's column with FMAs.
template <>
__device__ __forceinline__ void dt_tile<float>(const Fold<float>& f, int rank, int i0,
                                               float (*tile)[kWarpSize + 1]) {
  const int lane = threadIdx.x % kWarpSize;
  const float* w = f.W + threadIdx.x * f.w_stride;
  const float* rows = f.dtr + ((i0 - kDtrLead) & (kDtrSlots - 1)) * f.dtr_stride;
  float acc[kDtRows];
#pragma unroll
  for (int j = 0; j < kDtRows; ++j) acc[j] = 0.0f;
  for (int r = 0; r < rank; ++r) {
    const float wr = w[r];
#pragma unroll
    for (int j = 0; j < kDtRows; ++j) acc[j] = fmaf(rows[j * f.dtr_stride + r], wr, acc[j]);
  }
  const float bias = f.bias[threadIdx.x];
#pragma unroll
  for (int j = 0; j < kDtRows; ++j) tile[j][lane] = softplus(acc[j] + bias);
}

// Four 8x8 matrices of 16-bit values from shared memory: lanes 8m .. 8m+7
// give the row addresses of matrix m; register m of lane l holds row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1 of matrix m.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(smem)))
               : "memory");
}

// bf16: the (16 steps x rank) @ (rank x 32 channels) product on the tensor
// cores, mma.sync m16n8k16 (row-major A = dtr rows, column-major B = W's
// channel rows) over ceil(rank / 16) steps of 16 (the staged rows hold
// zeros past the rank), four 8-channel tiles; fp32 sums. Per k-step one
// ldmatrix.x4 gives A (rows 0-7 and 8-15, columns 0-7 and 8-15) and two
// give B (two 8-channel tiles, columns 0-7 and 8-15 each). Lane (g = lane
// / 4, q = lane % 4) holds the sums at rows g, g + 8 and channels 2q, 2q + 1
// of each tile. mma_ksteps adds the product of `cols` columns (from a_ptr
// and b_ptr, this lane's ldmatrix addresses) to acc.
__device__ __forceinline__ void mma_ksteps(float (&acc)[4][4], const __nv_bfloat16* a_ptr,
                                           const __nv_bfloat16* b_ptr, int b_stride, int cols) {
  for (int k0 = 0; k0 < cols; k0 += 16) {
    unsigned a[4];
    ldmatrix_x4(a, a_ptr + k0);
#pragma unroll
    for (int pair = 0; pair < 2; ++pair) {
      unsigned bb[4];
      ldmatrix_x4(bb, b_ptr + pair * 16 * b_stride + k0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* c = acc[2 * pair + h];
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(bb[2 * h]), "r"(bb[2 * h + 1]));
      }
    }
  }
}

template <>
__device__ __forceinline__ void dt_tile<__nv_bfloat16>(const Fold<__nv_bfloat16>& f, int rank,
                                                       int i0, float (*tile)[kWarpSize + 1]) {
  const int lane = threadIdx.x % kWarpSize;
  const int warp = threadIdx.x / kWarpSize;
  const int g = lane / 4, q = lane % 4;
  const int m = lane / 8, r8 = lane % 8;  // the matrix this lane addresses, and its row
  const __nv_bfloat16* a_ptr = f.dtr +
      (((i0 - kDtrLead) & (kDtrSlots - 1)) + r8 + (m & 1) * 8) * f.dtr_stride + (m >> 1) * 8;
  const __nv_bfloat16* b_ptr =
      f.W + (warp * kWarpSize + (m >> 1) * 8 + r8) * f.w_stride + (m & 1) * 8;
  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  }
  mma_ksteps(acc, a_ptr, b_ptr, f.w_stride, rank);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = nt * 8 + 2 * q + e;
      const float bias = f.bias[warp * kWarpSize + c];
      tile[g][c] = softplus(acc[nt][e] + bias);
      tile[g + 8][c] = softplus(acc[nt][2 + e] + bias);
    }
  }
}

// The windowed form: one window's product, over its `cols` rank columns
// from column k0, added to the chunk's dt sums of the calling warp's
// channels at the chunk's steps tile * kDtRows .. + kDtRows - 1 (from zero
// at the first window); at the last window the softplus of the sum and the
// bias replaces it. Every lane of the warp calls it; each lane reads back
// only what it wrote.
template <typename T>
__device__ __forceinline__ void dt_win_tile(const FoldWin<T>& f, int tile, int k0, int cols,
                                            bool first, bool last);

// fp32: each lane its own channel, W's row from global memory.
template <>
__device__ __forceinline__ void dt_win_tile<float>(const FoldWin<float>& f, int tile, int k0,
                                                   int cols, bool first, bool last) {
  constexpr int kStride = win_stride<float>(kWinCols<float>);
  const int c = threadIdx.x;
  const float* w = f.W + k0;
  const float* rows = f.dtr + tile * kDtRows * kStride;
  float (*dt)[kDtcStride] = f.dt + tile * kDtRows;
  float acc[kDtRows];
#pragma unroll
  for (int j = 0; j < kDtRows; ++j) acc[j] = first ? 0.0f : dt[j][c];
  for (int r = 0; r < cols; ++r) {
    const float wr = w[r];
#pragma unroll
    for (int j = 0; j < kDtRows; ++j) acc[j] = fmaf(rows[j * kStride + r], wr, acc[j]);
  }
  const float bias = f.bias[c];
#pragma unroll
  for (int j = 0; j < kDtRows; ++j) dt[j][c] = last ? softplus(acc[j] + bias) : acc[j];
}

// bf16: the tensor-core product of dt_tile on the window's staged columns
// (column 0 of the window is rank column k0), the sums in the same
// fragments.
template <>
__device__ __forceinline__ void dt_win_tile<__nv_bfloat16>(const FoldWin<__nv_bfloat16>& f,
                                                           int tile, int k0, int cols,
                                                           bool first, bool last) {
  constexpr int kStride = win_stride<__nv_bfloat16>(kWinCols<__nv_bfloat16>);
  const int lane = threadIdx.x % kWarpSize;
  const int warp = threadIdx.x / kWarpSize;
  const int g = lane / 4, q = lane % 4;
  const int m = lane / 8, r8 = lane % 8;
  const __nv_bfloat16* a_ptr = f.dtr + (tile * kDtRows + r8 + (m & 1) * 8) * kStride + (m >> 1) * 8;
  const __nv_bfloat16* b_ptr = f.W + (warp * kWarpSize + (m >> 1) * 8 + r8) * kStride + (m & 1) * 8;
  float (*dt)[kDtcStride] = f.dt + tile * kDtRows;
  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = warp * kWarpSize + nt * 8 + 2 * q + e;
      acc[nt][e] = first ? 0.0f : dt[g][c];
      acc[nt][2 + e] = first ? 0.0f : dt[g + 8][c];
    }
  }
  mma_ksteps(acc, a_ptr, b_ptr, kStride, cols);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = warp * kWarpSize + nt * 8 + 2 * q + e;
      const float bias = f.bias[c];
      dt[g][c] = last ? softplus(acc[nt][e] + bias) : acc[nt][e];
      dt[g + 8][c] = last ? softplus(acc[nt][2 + e] + bias) : acc[nt][2 + e];
    }
  }
}

// One sub-chunk's per-step streams of a chain.
struct SubStreams {
  float dt[kSub];
  float u[kSub];
  float z[kSub];
};

// The walk of chain (b, d) of one direction. Every thread of the block
// calls it (the staging of B/C synchronises the block); threads past the
// last channel stage and compute on channel 0 but write nothing. kDirect
// reads B/C from global memory at every step instead (s_B and s_C unused,
// no barriers). kFdt (the fuse_dt form) reads dt from the warp's tile
// fold->dt[warp], formed every kDtRows steps from fold's staged operands
// (kWGlobal: W read from global memory, not staged); kStage rounds to bf16
// where the stage form does. kWin (the windowed fuse_dt form, with kFdt)
// reads dt from win->dt instead, formed at every chunk's start by the whole
// block over rank windows. kDelta (the eval forms) reads delta in dt's
// place and forms dt = softplus(delta + bias) in the walk (p.bias, p.softplus).
// The ungated build (aum::kGated false) writes the fp32 partial y_t and
// reads neither z nor D.
template <typename T, bool kSave, bool kState, bool kDirect, bool kFdt = false,
          bool kStage = false, bool kWGlobal = false, bool kWin = false, bool kDelta = false>
__device__ __forceinline__ void scan_walk(const ScanDir& p, bool reverse, int seqlen,
                                          int dim, int dstate, float (*s_B)[kMaxN],
                                          float (*s_C)[kMaxN],
                                          const Fold<T>* fold = nullptr,
                                          const FoldWin<T>* win = nullptr) {
  static_assert(!kWin || kFdt, "the windowed form is a fuse_dt form");
  static_assert(!kStage || !kFdt, "the stage form is off in the fuse_dt form");
  static_assert(!kDelta || (!kSave && !kFdt && !kStage), "the in-kernel dt is the eval forms'");
  using Out = std::conditional_t<aum::kGated, T, float>;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + tid;
  const bool active = d < dim;
  const int dc = active ? d : 0;

  const T* u = static_cast<const T*>(p.u) + b * p.u_sb + dc;
  const T* dt = static_cast<const T*>(p.dt) + b * p.dt_sb + dc;
  const T* z = static_cast<const T*>(p.z) + b * p.z_sb + dc;
  const T* Bm = static_cast<const T*>(p.B) + b * p.B_sb;
  const T* Cm = static_cast<const T*>(p.C) + b * p.C_sb;
  Out* out = static_cast<Out*>(p.out) + static_cast<long long>(b) * seqlen * dim + dc;
  const long long state_row = static_cast<long long>(b) * dstate * dim + dc;  // [b, 0, d]

  // a[n] = A[d, n] log2 e, so that the decay is one multiply and one exp2
  // (the stage form multiplies bf16(dt log2 e) by A itself). States n >=
  // dstate keep a = 0, B = 0 and x = 0: they stay zero.
  float a[kMaxN], x[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    const bool has_n = active && n < dstate;
    a[n] = has_n ? p.A[static_cast<long long>(d) * dstate + n] * (kStage ? 1.0f : kLog2e) : 0.0f;
    x[n] = (kState && has_n) ? p.x0[state_row + static_cast<long long>(n) * dim] : 0.0f;
  }
  const float dskip = aum::kGated ? p.Dskip[dc] : 0.0f;
  // kDelta: the chain's dt bias (zero where none) and whether the softplus applies.
  const float dt_bias = kDelta && p.bias != nullptr ? p.bias[dc] : 0.0f;
  const bool dt_softplus = kDelta && p.softplus != 0;

  auto step_of = [&](int i) { return reverse ? seqlen - 1 - i : i; };
  // Element steps between consecutive processed steps (negative reversed).
  const int dir = reverse ? -1 : 1;
  const long long dt_step = dir * p.dt_sl, u_step = dir * p.u_sl, z_step = dir * p.z_sl;
  // The windowed form's dt of the chunk whose first processed step is i0:
  // per window of kWinCols<T> rank columns, its columns of the block's W
  // rows (bf16) and of the chunk's dtr rows (past the end: the last
  // step's) staged, then each warp's product added to its channels' sums.
  // Every thread of the block calls it.
  auto dt_chunk = [&](int i0) {
    constexpr int kCols = kWinCols<T>;
    constexpr int kStride = win_stride<T>(kCols);
    const int rank = p.rank;
    const T* dtr = static_cast<const T*>(p.dtr) + b * p.dtr_sb;
    const T* wt = static_cast<const T*>(p.Wt);
    const int d0 = blockIdx.x * kThreads;
    for (int k0 = 0; k0 < rank; k0 += kCols) {
      const int cols = min(kCols, rank - k0);
      __syncthreads();  // the previous window's (or chunk's) readers are done
      if constexpr (sizeof(T) == 2) {
        stage_rows<T>(
            [&](int r) { return wt + static_cast<long long>(min(d0 + r, dim - 1)) * p.Wt_sd + k0; },
            [&](int r) { return win->W + r * kStride; }, kThreads, cols,
            whole_rows16<T>(p.Wt, rank, p.Wt_sd, 0));
      }
      stage_rows<T>(
          [&](int r) {
            return dtr + static_cast<long long>(step_of(min(i0 + r, seqlen - 1))) * p.dtr_sl + k0;
          },
          [&](int r) { return win->dtr + r * kStride; }, kChunk, cols,
          whole_rows16<T>(p.dtr, rank, p.dtr_sb, p.dtr_sl));
      if constexpr (sizeof(T) == 2) {
        // Zeros from the window's last column to its last k-step's.
        const int pad = (cols + 15) / 16 * 16 - cols;
        for (int idx = tid; idx < (kThreads + kChunk) * pad; idx += kThreads) {
          const int r = idx / pad;
          T* row = r < kThreads ? win->W + r * kStride : win->dtr + (r - kThreads) * kStride;
          row[cols + idx % pad] = aum::from_float<T>(0.0f);
        }
      }
      cp_async_wait_all();
      __syncthreads();
      for (int tile = 0; tile < kChunk / kDtRows; ++tile) {
        dt_win_tile<T>(*win, tile, k0, cols, k0 == 0, k0 + cols >= rank);
      }
    }
    __syncwarp();  // each warp reads back its own channels' dt
  };
  auto load_sub = [&](SubStreams& s, int i0) {
    const long long t0 = step_of(i0);
    const T* pd = dt + t0 * p.dt_sl;
    const T* pu = u + t0 * p.u_sl;
    const T* pz = z + t0 * p.z_sl;
    if constexpr (kWin) {
      // A new chunk's dt; the previous chunk's is in registers already.
      if (i0 % kChunk == 0) dt_chunk(i0);
    } else if constexpr (kFdt) {
      // A new tile every kDtRows steps; the rows it replaces are in
      // registers already (this sub-chunk's cur was loaded from them).
      if (i0 % kDtRows == 0) {
        __syncwarp();
        dt_tile<T>(*fold, p.rank, i0, fold->dt[tid / kWarpSize]);
        __syncwarp();
      }
    }
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const bool in = i0 + j < seqlen;  // past the end: zeros, unused
      if constexpr (kWin) {
        s.dt[j] = in ? win->dt[i0 % kChunk + j][tid] : 0.0f;
      } else if constexpr (kFdt) {
        s.dt[j] = in ? fold->dt[tid / kWarpSize][i0 % kDtRows + j][tid % kWarpSize] : 0.0f;
      } else {
        s.dt[j] = in ? aum::to_float(pd[j * dt_step]) : 0.0f;
      }
      s.u[j] = in ? aum::to_float(pu[j * u_step]) : 0.0f;
      s.z[j] = aum::kGated && in ? aum::to_float(pz[j * z_step]) : 0.0f;
    }
  };
  // The direct kernel reads B_t/C_t in 16-byte vectors where every row is
  // whole and aligned (N = 16 and the mixer's layout), else value by value.
  const bool rows16 = kDirect && dstate == kMaxN && aum::aligned16(Bm) &&
                      aum::aligned16(Cm) && p.B_sl * sizeof(T) % 16 == 0 &&
                      p.C_sl * sizeof(T) % 16 == 0;

  // The fuse_dt form's dtr rows of processed steps [i_first, i_first +
  // count) (past the end: the last step's) into their slots of the ring.
  auto stage_dtr = [&](int i_first, int count) {
    const T* dtr = static_cast<const T*>(p.dtr) + b * p.dtr_sb;
    stage_rows<T>(
        [&](int r) { return dtr + static_cast<long long>(step_of(min(i_first + r, seqlen - 1))) *
                                      p.dtr_sl; },
        [&](int r) { return fold->dtr + ((i_first + r - kDtrLead) & (kDtrSlots - 1)) *
                                            fold->dtr_stride; },
        count, p.rank, whole_rows16<T>(p.dtr, p.rank, p.dtr_sb, p.dtr_sl));
  };
  if constexpr (kWin) {
    win->bias[tid] = p.bias[dc];  // read after dt_chunk's first barrier
  } else if constexpr (kFdt) {
    // Once per block: W's rows of the block's channels (past the last
    // channel: the last one's), the zeros past the rank (bf16), the biases,
    // and the dtr rows of the first tile and of the first window.
    const int rank = p.rank;
    const T* wt = static_cast<const T*>(p.Wt);
    const int d0 = blockIdx.x * kThreads;
    if constexpr (!kWGlobal) {
      stage_rows<T>(
          [&](int r) { return wt + static_cast<long long>(min(d0 + r, dim - 1)) * p.Wt_sd; },
          [&](int r) { return fold->W + r * fold->w_stride; }, kThreads, rank,
          sizeof(T) == 2 && whole_rows16<T>(p.Wt, rank, p.Wt_sd, 0));
    }
    if constexpr (sizeof(T) == 2) {
      const int pad = (rank + 15) / 16 * 16 - rank;
      for (int idx = tid; idx < (kThreads + kDtrSlots) * pad; idx += kThreads) {
        const int r = idx / pad, k = rank + idx % pad;
        T* row = r < kThreads ? fold->W + r * fold->w_stride
                              : fold->dtr + (r - kThreads) * fold->dtr_stride;
        row[k] = aum::from_float<T>(0.0f);
      }
    }
    fold->bias[tid] = p.bias[dc];
    stage_dtr(0, kDtrLead + kChunk);
    cp_async_wait_all();
    __syncthreads();
  }

  SubStreams cur, nxt;
  load_sub(cur, 0);
  for (int i0 = 0; i0 < seqlen; i0 += kSub) {
    if (i0 % kChunk == 0) {
      if constexpr (!kDirect) {
        // Stage the chunk's B_t, C_t (zeros beyond dstate): every load first.
        const int len = min(kChunk, seqlen - i0);
        constexpr int kPer = kMaxN * kChunk / kThreads;
        float vb[kPer], vc[kPer];
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          const int idx = tid + r * kThreads;
          const int i = idx / kMaxN, n = idx % kMaxN;
          const bool in = i < len && n < dstate;
          const int t = step_of(min(i0 + i, seqlen - 1));
          vb[r] = in ? aum::to_float(Bm[t * p.B_sl + n]) : 0.0f;
          vc[r] = in ? aum::to_float(Cm[t * p.C_sl + n]) : 0.0f;
        }
        if constexpr (kFdt && !kWin) cp_async_wait_all();  // this chunk's window, staged a chunk ago
        __syncthreads();  // the previous chunk's readers are done with s_B/s_C
        if constexpr (kFdt && !kWin) {
          // The next window, into the half of the ring the previous one held.
          const int first = i0 + kChunk + kDtrLead;
          if (first < seqlen) stage_dtr(first, kChunk);
        }
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          const int idx = tid + r * kThreads;
          s_B[idx / kMaxN][idx % kMaxN] = vb[r];
          s_C[idx / kMaxN][idx % kMaxN] = vc[r];
        }
        __syncthreads();
      }
      if (kSave && active) {
        float* xb = p.xb + ((static_cast<long long>(b) * ((seqlen + kChunk - 1) / kChunk)
                             + i0 / kChunk) * dstate) * dim + d;
#pragma unroll
        for (int n = 0; n < kMaxN; ++n) {  // constant indices keep x in registers
          if (n < dstate) xb[static_cast<long long>(n) * dim] = x[n];
        }
      }
    }
    if (i0 + kSub < seqlen) load_sub(nxt, i0 + kSub);  // in flight while this one is walked
    if constexpr (kDelta) {
      // This sub-chunk's dt from its deltas (loaded a sub-chunk ago), in
      // place; steps past the end form a dt that is never used.
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float v = cur.dt[j] + dt_bias;
        cur.dt[j] = dt_softplus ? softplus(v) : v;
      }
    }
    const int slen = min(kSub, seqlen - i0);
    const int ic = i0 % kChunk;  // the sub-chunk's first row of s_B/s_C
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      if (j < slen) {
        float bt[kMaxN], ct[kMaxN];
        if constexpr (kDirect) {
          const long long t = step_of(i0 + j);
          const T* brow = Bm + t * p.B_sl;
          const T* crow = Cm + t * p.C_sl;
          if (rows16) {
            aum::load_row16(brow, bt);
            aum::load_row16(crow, ct);
          } else {
#pragma unroll
            for (int n = 0; n < kMaxN; ++n) {
              bt[n] = n < dstate ? aum::to_float(__ldg(brow + n)) : 0.0f;
              ct[n] = n < dstate ? aum::to_float(__ldg(crow + n)) : 0.0f;
            }
          }
        } else {
#pragma unroll
          for (int n = 0; n < kMaxN; ++n) {
            bt[n] = s_B[ic + j][n];
            ct[n] = s_C[ic + j][n];
          }
        }
        const float dtv = kStage ? round_bf16(cur.dt[j] * kLog2eBf16) : cur.dt[j];
        const float dtu = kStage ? round_bf16(cur.dt[j] * cur.u[j]) : dtv * cur.u[j];
        float y = 0.0f;
#pragma unroll
        for (int n = 0; n < kMaxN; ++n) {
          x[n] = aum::exp2_sfu(dtv * a[n]) * x[n] + dtu * bt[n];
          y = fmaf(ct[n], x[n], y);
        }
        if (active) {
          if constexpr (aum::kGated) {
            out[static_cast<long long>(step_of(i0 + j)) * dim] =
                aum::from_float<T>(fmaf(dskip, cur.u[j], y) * aum::silu_fast(cur.z[j]));
          } else {
            out[static_cast<long long>(step_of(i0 + j)) * dim] = y;
          }
        }
      }
    }
    cur = nxt;
  }
  if (kState && active) {
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) {
      if (n < dstate) p.xfin[state_row + static_cast<long long>(n) * dim] = x[n];
    }
  }
}

// Both directions of one bidirectional layer: blockIdx.z 0 forward, 1
// reverse. The eval form (no saved states) forms dt in the walk.
template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads, kSave ? kMinBlocks : kMinBlocksWide)
scan_dual_fwd_kernel(const ScanDir fwd, const ScanDir rev, int seqlen, int dim, int dstate) {
  __shared__ __align__(16) float s_B[kChunk][kMaxN];
  __shared__ __align__(16) float s_C[kChunk][kMaxN];
  const bool reverse = blockIdx.z == 1;
  scan_walk<T, kSave, false, false, false, false, false, false, !kSave>(
      reverse ? rev : fwd, reverse, seqlen, dim, dstate, s_B, s_C);
}

// The fuse_dt form (eval): dt formed from dtr, Wt and bias in the kernel;
// fold_dyn_smem<T>(rank) bytes of dynamic shared memory (the larger of the
// two directions' ranks), or with kWGlobal (fp32) the ring's alone.
template <typename T, bool kWGlobal = false>
__global__ void __launch_bounds__(kThreads, kMinBlocksWide)
scan_dual_fdt_fwd_kernel(const ScanDir fwd, const ScanDir rev, int seqlen, int dim,
                         int dstate) {
  __shared__ __align__(16) float s_B[kChunk][kMaxN];
  __shared__ __align__(16) float s_C[kChunk][kMaxN];
  __shared__ float s_dt[kWarps][kDtRows][kWarpSize + 1];
  __shared__ float s_bias[kThreads];
  extern __shared__ __align__(16) unsigned char s_fold[];
  const bool reverse = blockIdx.z == 1;
  const ScanDir& p = reverse ? rev : fwd;
  T* w = reinterpret_cast<T*>(s_fold);
  if constexpr (kWGlobal) {
    const int row = min(static_cast<int>(blockIdx.x) * kThreads + static_cast<int>(threadIdx.x),
                        dim - 1);
    T* w_row = const_cast<T*>(static_cast<const T*>(p.Wt)) + static_cast<long long>(row) * p.Wt_sd;
    const Fold<T> fold = {w_row, w, s_bias, s_dt, 0, fold_dtr_stride<T>(p.rank)};
    scan_walk<T, false, false, false, true, false, true>(p, reverse, seqlen, dim, dstate, s_B,
                                                         s_C, &fold);
  } else {
    const Fold<T> fold = {w, w + kThreads * fold_w_stride<T>(p.rank), s_bias, s_dt,
                          fold_w_stride<T>(p.rank), fold_dtr_stride<T>(p.rank)};
    scan_walk<T, false, false, false, true>(p, reverse, seqlen, dim, dstate, s_B, s_C, &fold);
  }
}

// The windowed fuse_dt form (dt ranks past kWholeRank, eval): dt formed per
// chunk over rank windows; win_dyn_smem<T>(kWinCols<T>) bytes of dynamic
// shared memory, two blocks an SM (at most 255 registers a thread).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
scan_dual_fdt_win_fwd_kernel(const ScanDir fwd, const ScanDir rev, int seqlen, int dim,
                             int dstate) {
  __shared__ __align__(16) float s_B[kChunk][kMaxN];
  __shared__ __align__(16) float s_C[kChunk][kMaxN];
  __shared__ float s_dtc[kChunk][kDtcStride];
  __shared__ float s_bias[kThreads];
  extern __shared__ __align__(16) unsigned char s_fold[];
  const bool reverse = blockIdx.z == 1;
  const ScanDir& p = reverse ? rev : fwd;
  constexpr int kStride = win_stride<T>(kWinCols<T>);
  T* w = reinterpret_cast<T*>(s_fold);
  FoldWin<T> fold = {w, w, s_bias, s_dtc};
  if constexpr (sizeof(T) == 2) {
    fold.dtr = w + kThreads * kStride;
  } else {
    const int row = min(static_cast<int>(blockIdx.x) * kThreads + static_cast<int>(threadIdx.x),
                        dim - 1);
    fold.W = const_cast<T*>(static_cast<const T*>(p.Wt)) + static_cast<long long>(row) * p.Wt_sd;
  }
  scan_walk<T, false, false, false, true, false, false, true>(p, reverse, seqlen, dim, dstate,
                                                              s_B, s_C, nullptr, &fold);
}

// The windowed form's dynamic shared memory, with the kernel allowed to
// take it.
template <typename T>
int fdt_win_smem() {
  constexpr int bytes = win_dyn_smem<T>(kWinCols<T>);
  static_assert(kWinStaticSmem + bytes > kDefaultSmem, "the windowed form opts in");
  cudaFuncSetAttribute(scan_dual_fdt_win_fwd_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return bytes;
}

// The fuse_dt kernel's dynamic shared memory at `rank`, with the kernel
// allowed to take it (above 48 KB in all it has to opt in).
template <typename T, bool kWGlobal = false>
int fdt_smem(int rank) {
  const int bytes = fold_smem(rank, sizeof(T) == 4) - kFdtStaticSmem;
  if (kFdtStaticSmem + bytes > kDefaultSmem) {
    cudaFuncSetAttribute(scan_dual_fdt_fwd_kernel<T, kWGlobal>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  return bytes;
}

// The stage form (bf16 streams only), eval and saving.
template <bool kSave>
__global__ void __launch_bounds__(kThreads, kSave ? kMinBlocks : kMinBlocksWide)
scan_dual_stage_fwd_kernel(const ScanDir fwd, const ScanDir rev, int seqlen, int dim,
                           int dstate) {
  __shared__ __align__(16) float s_B[kChunk][kMaxN];
  __shared__ __align__(16) float s_C[kChunk][kMaxN];
  const bool reverse = blockIdx.z == 1;
  scan_walk<__nv_bfloat16, kSave, false, false, false, true>(reverse ? rev : fwd, reverse,
                                                             seqlen, dim, dstate, s_B, s_C);
}

// The same, reading B/C per step from global memory.
template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads, kMinBlocksWide)
scan_dual_direct_fwd_kernel(const ScanDir fwd, const ScanDir rev, int seqlen, int dim,
                            int dstate) {
  const bool reverse = blockIdx.z == 1;
  scan_walk<T, kSave, false, true, false, false, false, false, !kSave>(
      reverse ? rev : fwd, reverse, seqlen, dim, dstate, nullptr, nullptr);
}

// One direction, reversed or not at run time; the eval forms (as is and
// with_state) form dt in the walk.
template <typename T, bool kSave, bool kState>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_single_fwd_kernel(const ScanDir p, int reverse, int seqlen, int dim, int dstate) {
  __shared__ __align__(16) float s_B[kChunk][kMaxN];
  __shared__ __align__(16) float s_C[kChunk][kMaxN];
  scan_walk<T, kSave, kState, false, false, false, false, false, !kSave>(
      p, reverse != 0, seqlen, dim, dstate, s_B, s_C);
}

dim3 grid_of(int batch, int dim, int dirs) {
  return dim3((dim + kThreads - 1) / kThreads, batch, dirs);
}

// The dual forward kernels: the staged one, the direct one, the fuse_dt
// form and the stage form.
enum class DualKind { kStaged, kDirect, kFdt, kStage };

template <typename T>
void launch_dual(const ScanDir& fwd, const ScanDir& rev, DualKind kind, int batch, int seqlen,
                 int dim, int dstate, cudaStream_t s) {
  const dim3 grid = grid_of(batch, dim, 2);
  const bool save = fwd.xb != nullptr;
  const bool direct = kind == DualKind::kDirect;
  if (kind == DualKind::kFdt) {
    const int rank = fwd.rank > rev.rank ? fwd.rank : rev.rank;
    if (rank > kWholeRank) {
      const int smem = fdt_win_smem<T>();
      scan_dual_fdt_win_fwd_kernel<T><<<grid, kThreads, smem, s>>>(fwd, rev, seqlen, dim, dstate);
      return;
    }
    if constexpr (sizeof(T) == 4) {
      if (fold_w_global(rank, true)) {
        // Both directions' W rows from global memory, the ring sized by the larger rank.
        const int smem = fdt_smem<T, true>(rank);
        scan_dual_fdt_fwd_kernel<T, true><<<grid, kThreads, smem, s>>>(fwd, rev, seqlen, dim,
                                                                       dstate);
        return;
      }
    }
    const int smem = fdt_smem<T>(rank);
    scan_dual_fdt_fwd_kernel<T><<<grid, kThreads, smem, s>>>(fwd, rev, seqlen, dim, dstate);
  } else if (kind == DualKind::kStage) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      if (save) {
        scan_dual_stage_fwd_kernel<true><<<grid, kThreads, 0, s>>>(fwd, rev, seqlen, dim, dstate);
      } else {
        scan_dual_stage_fwd_kernel<false><<<grid, kThreads, 0, s>>>(fwd, rev, seqlen, dim, dstate);
      }
    }
  } else if (direct && save) {
    scan_dual_direct_fwd_kernel<T, true><<<grid, kThreads, 0, s>>>(fwd, rev, seqlen, dim,
                                                                    dstate);
  } else if (direct) {
    scan_dual_direct_fwd_kernel<T, false><<<grid, kThreads, 0, s>>>(fwd, rev, seqlen, dim,
                                                                     dstate);
  } else if (save) {
    scan_dual_fwd_kernel<T, true><<<grid, kThreads, 0, s>>>(fwd, rev, seqlen, dim, dstate);
  } else {
    scan_dual_fwd_kernel<T, false><<<grid, kThreads, 0, s>>>(fwd, rev, seqlen, dim, dstate);
  }
}

template <typename T, bool kState>
void launch_single_state(const ScanDir& p, int reverse, int batch, int seqlen, int dim,
                         int dstate, cudaStream_t s) {
  const dim3 grid = grid_of(batch, dim, 1);
  if (p.xb != nullptr) {
    scan_single_fwd_kernel<T, true, kState><<<grid, kThreads, 0, s>>>(
        p, reverse, seqlen, dim, dstate);
  } else {
    scan_single_fwd_kernel<T, false, kState><<<grid, kThreads, 0, s>>>(
        p, reverse, seqlen, dim, dstate);
  }
}

template <typename T>
void launch_single(const ScanDir& p, int reverse, int batch, int seqlen, int dim,
                   int dstate, cudaStream_t s) {
  if (p.x0 != nullptr) {
    launch_single_state<T, true>(p, reverse, batch, seqlen, dim, dstate, s);
  } else {
    launch_single_state<T, false>(p, reverse, batch, seqlen, dim, dstate, s);
  }
}

bool bad_sizes(int batch, int seqlen, int dim, int dstate) {
  return dstate < 1 || dstate > kMaxN || batch < 1 || seqlen < 1 || dim < 1;
}

bool bad_fold(const ScanDir& p) {
  return p.dtr == nullptr || p.Wt == nullptr || p.bias == nullptr || p.rank < 1;
}

// A form that streams the activated dt (saving, stage) takes no bias and no
// softplus: only the eval forms form dt.
bool bad_dt_form(const ScanDir& p, bool streams_dt) {
  return streams_dt && (p.softplus != 0 || p.bias != nullptr);
}

int dual_fwd(const ScanDir* fwd, const ScanDir* rev, DualKind kind, int batch, int seqlen,
             int dim, int dstate, int dtype, void* stream) {
  if (bad_sizes(batch, seqlen, dim, dstate) ||
      (fwd->xb == nullptr) != (rev->xb == nullptr) || fwd->x0 != nullptr ||
      fwd->xfin != nullptr || rev->x0 != nullptr || rev->xfin != nullptr ||
      (kind == DualKind::kFdt && (fwd->xb != nullptr || bad_fold(*fwd) || bad_fold(*rev))) ||
      (kind == DualKind::kStage && dtype != 1) ||
      (kind != DualKind::kFdt &&
       (bad_dt_form(*fwd, fwd->xb != nullptr || kind == DualKind::kStage) ||
        bad_dt_form(*rev, rev->xb != nullptr || kind == DualKind::kStage)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_dual<float>(*fwd, *rev, kind, batch, seqlen, dim, dstate, s);
  } else if (dtype == 1) {
    launch_dual<__nv_bfloat16>(*fwd, *rev, kind, batch, seqlen, dim, dstate, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The chunk length of the saved states (xb's second axis is ceil(L / it)).
int aum_scan_state_chunk() { return kChunk; }

// The resources of the i-th kernel instantiation this library launches
// (aum_kernel_resources in common.cuh: info[0..5]) and its name; 0 on
// success, a CUDA error, or -1 past the last one.
int aum_kernel_info(int i, int* info, const char** name) {
  int n = 0;
#define AUM_KERNEL(...)                                             \
  if (i == n++) {                                                   \
    *name = #__VA_ARGS__;                                           \
    return aum_kernel_resources(__VA_ARGS__, kThreads, 0, info);    \
  }
  AUM_KERNEL(scan_dual_fwd_kernel<__nv_bfloat16, false>)
  AUM_KERNEL(scan_dual_fwd_kernel<__nv_bfloat16, true>)
  AUM_KERNEL(scan_dual_direct_fwd_kernel<__nv_bfloat16, false>)
  AUM_KERNEL(scan_dual_direct_fwd_kernel<__nv_bfloat16, true>)
  AUM_KERNEL(scan_single_fwd_kernel<__nv_bfloat16, false, false>)
  AUM_KERNEL(scan_single_fwd_kernel<__nv_bfloat16, true, false>)
  AUM_KERNEL(scan_single_fwd_kernel<__nv_bfloat16, false, true>)
  AUM_KERNEL(scan_single_fwd_kernel<__nv_bfloat16, true, true>)
  AUM_KERNEL(scan_dual_fwd_kernel<float, false>)
  AUM_KERNEL(scan_dual_fwd_kernel<float, true>)
  AUM_KERNEL(scan_dual_direct_fwd_kernel<float, false>)
  AUM_KERNEL(scan_dual_direct_fwd_kernel<float, true>)
  AUM_KERNEL(scan_single_fwd_kernel<float, false, false>)
  AUM_KERNEL(scan_single_fwd_kernel<float, true, false>)
  AUM_KERNEL(scan_single_fwd_kernel<float, false, true>)
  AUM_KERNEL(scan_single_fwd_kernel<float, true, true>)
  AUM_KERNEL(scan_dual_stage_fwd_kernel<false>)
  AUM_KERNEL(scan_dual_stage_fwd_kernel<true>)
#undef AUM_KERNEL
  // The fuse_dt form at AuM-Base's dt rank, at 64, at a width-4096 model's
  // 256 (fp32 there: W in global memory) and at the largest held whole.
#define AUM_FDT_KERNEL(T, rank, ...)                                                 \
  if (i == n++) {                                                                    \
    *name = "scan_dual_fdt_fwd_kernel<" #T #__VA_ARGS__ "> rank " #rank;             \
    return aum_kernel_resources(scan_dual_fdt_fwd_kernel<T __VA_ARGS__>, kThreads,   \
                                fdt_smem<T __VA_ARGS__>(rank), info);                \
  }
  AUM_FDT_KERNEL(__nv_bfloat16, 48)
  AUM_FDT_KERNEL(__nv_bfloat16, 64)
  AUM_FDT_KERNEL(float, 48)
  AUM_FDT_KERNEL(float, 64)
  AUM_FDT_KERNEL(__nv_bfloat16, 256)
  AUM_FDT_KERNEL(__nv_bfloat16, 400)
  AUM_FDT_KERNEL(float, 256, , true)
  AUM_FDT_KERNEL(float, 400, , true)
#undef AUM_FDT_KERNEL
  // The windowed form (every rank past kWholeRank alike).
#define AUM_FDT_WIN_KERNEL(T)                                                        \
  if (i == n++) {                                                                    \
    *name = "scan_dual_fdt_win_fwd_kernel<" #T "> rank > 400";                      \
    return aum_kernel_resources(scan_dual_fdt_win_fwd_kernel<T>, kThreads,           \
                                fdt_win_smem<T>(), info);                            \
  }
  AUM_FDT_WIN_KERNEL(__nv_bfloat16)
  AUM_FDT_WIN_KERNEL(float)
#undef AUM_FDT_WIN_KERNEL
  return -1;
}

// The fuse_dt form's largest dt rank held whole (past it the windowed form
// runs), and its shared memory per block (static and dynamic, bytes) at
// `rank` for dtype 0 (fp32) or 1 (bf16): the wrapper checks both at load.
int aum_scan_fdt_whole_rank() { return kWholeRank; }
int aum_scan_fdt_smem_bytes(int rank, int dtype) {
  if (rank <= kWholeRank) return fold_smem(rank, dtype == 0);
  return kWinStaticSmem + (dtype == 0 ? win_dyn_smem<float>(kWinCols<float>)
                                      : win_dyn_smem<__nv_bfloat16>(kWinCols<__nv_bfloat16>));
}

// dtype: 0 = fp32 streams, 1 = bf16 streams. Both directions save states
// (xb set in both) or neither does; neither carries a state in or out.
// Without saved states each forms dt from delta (bias, softplus).
// Returns cudaGetLastError() after the launch (0 on success); a refused
// launch never runs.
int aum_selective_scan_dual_fwd(const ScanDir* fwd, const ScanDir* rev,
                                int batch, int seqlen, int dim, int dstate,
                                int dtype, void* stream) {
  return dual_fwd(fwd, rev, DualKind::kStaged, batch, seqlen, dim, dstate, dtype, stream);
}

// The same function through the direct kernel (no staging of B/C).
int aum_selective_scan_dual_direct_fwd(const ScanDir* fwd, const ScanDir* rev,
                                       int batch, int seqlen, int dim, int dstate,
                                       int dtype, void* stream) {
  return dual_fwd(fwd, rev, DualKind::kDirect, batch, seqlen, dim, dstate, dtype, stream);
}

// The fuse_dt form (eval only: no saved states); dt unused, dtr, Wt, bias
// and rank (any from 1; past kWholeRank the windowed form) set in both
// directions.
int aum_selective_scan_dual_fdt_fwd(const ScanDir* fwd, const ScanDir* rev,
                                    int batch, int seqlen, int dim, int dstate,
                                    int dtype, void* stream) {
  return dual_fwd(fwd, rev, DualKind::kFdt, batch, seqlen, dim, dstate, dtype, stream);
}

// The stage form of the staged kernel, bf16 streams only (dtype 1).
int aum_selective_scan_dual_stage_fwd(const ScanDir* fwd, const ScanDir* rev,
                                      int batch, int seqlen, int dim, int dstate,
                                      int dtype, void* stream) {
  return dual_fwd(fwd, rev, DualKind::kStage, batch, seqlen, dim, dstate, dtype, stream);
}

// One direction; reverse != 0 walks t = L-1 .. 0. x0 and xfin are both set
// (the with_state form) or both null; without saved states dt is formed
// from delta (bias, softplus). dtype and the return value as above.
int aum_selective_scan_fwd(const ScanDir* p, int reverse, int batch, int seqlen, int dim,
                           int dstate, int dtype, void* stream) {
  if (bad_sizes(batch, seqlen, dim, dstate) || (p->x0 == nullptr) != (p->xfin == nullptr) ||
      bad_dt_form(*p, p->xb != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_single<float>(*p, reverse, batch, seqlen, dim, dstate, s);
  } else if (dtype == 1) {
    launch_single<__nv_bfloat16>(*p, reverse, batch, seqlen, dim, dstate, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

AUM_DEFINE_ERROR_STRING(aum_scan_error_string)
