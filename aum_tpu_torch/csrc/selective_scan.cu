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
// direction, per (batch b, channel d), with the pre-activated dt =
// softplus(delta + bias) streamed in delta's place:
//
//   x_t  = exp2(dt_t * (A[d, :] * log2 e)) * x_{t-1} + (dt_t * u_t) * B_t
//   y_t  = sum_n C_t[n] * x_t[n]
//   out  = (y_t + D[d] * u_t) * silu(z_t)          (cast to u's dtype)
//
// The forward direction walks t = 0 .. L-1, the reverse one t = L-1 .. 0.
//
// Two opt-in forms of _fwd_kernel_dual, each its own kernel on the same walk:
// - scan_dual_fdt_fwd_kernel (AUM_SCAN_FUSE_DT=1, eval, no saved states)
//   takes dtr, the (batch, L, R) dt-rank columns of x_proj's output, the
//   dt_proj weight W (R, D) and the fp32 bias in dt's place, and forms
//   dt = softplus(sum_r dtr[t, r] W[r, d] + bias[d]) itself, in fp32 (the
//   products of the stream dtype's values, fp32 sums, max(v, 0) +
//   log1p(exp(-|v|)) with the accurate expf/log1pf: once per element, not
//   per state). dt is never rounded to the stream dtype, as in the TPU
//   kernel: the one place where this form's outputs differ from the
//   default's. Each warp forms the dt of its 32 channels for 16 steps at a
//   time into a shared tile the walk reads: in bf16 with tensor-core
//   products (mma.sync m16n8k16, fp32 sums; a product of two bf16 values is
//   exact in fp32, as in the TPU kernel's fp32 dot), in fp32 with FMAs
//   (no TF32). No (batch, L, D) dt tensor is read or exists.
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
// accurate softplus (tens of FP32-pipe instructions, once per element and
// direction, not per state), and reads a (B, L, R) dtr in place of the
// (B, L, D) dt; on an H100 it took 1.75x the default kernel's time at the
// Fo-Bi bench shapes: the walk itself runs as fast as the default's, and
// each tile's loads, products and softplus, formed by the warp between two
// sub-chunks, come on top; the whole forward lost the (B, L, D) softplus
// passes of the dt it no longer reads.

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
  const float* Dskip;  // (D,) fp32
  void* out;           // (batch, L, D), contiguous, u's dtype
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
constexpr int kMaxRank = 64;   // the fuse_dt form's largest dt rank
static_assert(kChunk % kSub == 0, "chunks start on a sub-chunk");
static_assert(kDtRows % kSub == 0, "dt tiles start on a sub-chunk");
static_assert(kMaxN * kChunk % kThreads == 0, "the staging loop has no remainder");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The reference's softplus, accurate: the fuse_dt form runs it once per
// (step, channel).
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

// One dt tile of the fuse_dt form: dt of the warp's kWarpSize channels
// (from channel dw0) at processed steps i0 .. i0 + kDtRows - 1 of chain row
// b, into tile[row][channel]. Rows past the end and channels past the last
// one read zeros (their dt is never used). Every lane of the warp calls it.
template <typename T>
__device__ __forceinline__ void dt_tile(const ScanDir& p, bool reverse, int seqlen, int dim,
                                        int b, int i0, int dw0,
                                        float (*tile)[kWarpSize + 1]);

// fp32: each lane forms its own channel's column with FMAs.
template <>
__device__ __forceinline__ void dt_tile<float>(const ScanDir& p, bool reverse, int seqlen,
                                               int dim, int b, int i0, int dw0,
                                               float (*tile)[kWarpSize + 1]) {
  const int lane = threadIdx.x % kWarpSize;
  const int d = dw0 + lane;
  const bool active = d < dim;
  const float* dtr = static_cast<const float*>(p.dtr) + b * p.dtr_sb;
  const float* w = static_cast<const float*>(p.Wt) + static_cast<long long>(active ? d : 0) * p.Wt_sd;
  long long rows[kDtRows];
#pragma unroll
  for (int j = 0; j < kDtRows; ++j) {
    const int i = min(i0 + j, seqlen - 1);  // past the end: a row in range, unused
    rows[j] = static_cast<long long>(reverse ? seqlen - 1 - i : i) * p.dtr_sl;
  }
  float acc[kDtRows];
#pragma unroll
  for (int j = 0; j < kDtRows; ++j) acc[j] = 0.0f;
  for (int r = 0; r < p.rank; ++r) {
    const float wr = active ? w[r] : 0.0f;
#pragma unroll
    for (int j = 0; j < kDtRows; ++j) acc[j] = fmaf(__ldg(dtr + rows[j] + r), wr, acc[j]);
  }
  const float bias = active ? p.bias[d] : 0.0f;
#pragma unroll
  for (int j = 0; j < kDtRows; ++j) tile[j][lane] = softplus(acc[j] + bias);
}

// Two bf16 values as one 32-bit mma operand, the lower index in the low half.
__device__ __forceinline__ unsigned pack_bf16(unsigned short lo, unsigned short hi) {
  return static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
}

// bf16: the (16 steps x rank) @ (rank x 32 channels) product on the tensor
// cores, mma.sync m16n8k16 (row-major A = dtr rows, column-major B = Wt
// rows) over ceil(rank / 16) steps of 16 with zeros past the rank, four
// 8-channel tiles; fp32 sums. Lane (g = lane / 4, q = lane % 4) holds A at
// rows g, g + 8 and columns 2q, 2q + 1, 2q + 8, 2q + 9, B at columns 2q,
// 2q + 1, 2q + 8, 2q + 9 of channel g, and the sums at rows g, g + 8 and
// channels 2q, 2q + 1 of each tile.
template <>
__device__ __forceinline__ void dt_tile<__nv_bfloat16>(const ScanDir& p, bool reverse,
                                                       int seqlen, int dim, int b, int i0,
                                                       int dw0,
                                                       float (*tile)[kWarpSize + 1]) {
  const int lane = threadIdx.x % kWarpSize;
  const int g = lane / 4, q = lane % 4;
  const unsigned short* dtr =
      reinterpret_cast<const unsigned short*>(p.dtr) + b * p.dtr_sb;
  const unsigned short* wt = reinterpret_cast<const unsigned short*>(p.Wt);
  const int rank = p.rank;
  // The two A rows of this lane (zeros past the end) and the four B
  // channels (zeros past the last one).
  const bool in_lo = i0 + g < seqlen, in_hi = i0 + g + 8 < seqlen;
  const unsigned short* row_lo =
      dtr + static_cast<long long>(in_lo ? (reverse ? seqlen - 1 - (i0 + g) : i0 + g) : 0) * p.dtr_sl;
  const unsigned short* row_hi =
      dtr + static_cast<long long>(in_hi ? (reverse ? seqlen - 1 - (i0 + g + 8) : i0 + g + 8) : 0) * p.dtr_sl;
  auto a_at = [&](const unsigned short* row, bool in, int k) -> unsigned short {
    return in && k < rank ? __ldg(row + k) : static_cast<unsigned short>(0);
  };
  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  }
  for (int k0 = 0; k0 < rank; k0 += 16) {
    const int ka = k0 + 2 * q, kb = ka + 8;
    const unsigned a0 = pack_bf16(a_at(row_lo, in_lo, ka), a_at(row_lo, in_lo, ka + 1));
    const unsigned a1 = pack_bf16(a_at(row_hi, in_hi, ka), a_at(row_hi, in_hi, ka + 1));
    const unsigned a2 = pack_bf16(a_at(row_lo, in_lo, kb), a_at(row_lo, in_lo, kb + 1));
    const unsigned a3 = pack_bf16(a_at(row_hi, in_hi, kb), a_at(row_hi, in_hi, kb + 1));
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int d = dw0 + nt * 8 + g;
      const bool dn = d < dim;
      const unsigned short* wrow = wt + static_cast<long long>(dn ? d : 0) * p.Wt_sd;
      const unsigned b0 = pack_bf16(a_at(wrow, dn, ka), a_at(wrow, dn, ka + 1));
      const unsigned b1 = pack_bf16(a_at(wrow, dn, kb), a_at(wrow, dn, kb + 1));
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[nt][0]), "+f"(acc[nt][1]), "+f"(acc[nt][2]), "+f"(acc[nt][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = nt * 8 + 2 * q + e;
      const float bias = dw0 + c < dim ? p.bias[dw0 + c] : 0.0f;
      tile[g][c] = softplus(acc[nt][e] + bias);
      tile[g + 8][c] = softplus(acc[nt][2 + e] + bias);
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
// s_dt[warp], formed every kDtRows steps; kStage rounds to bf16 where the
// stage form does.
template <typename T, bool kSave, bool kState, bool kDirect, bool kFdt = false,
          bool kStage = false>
__device__ __forceinline__ void scan_walk(const ScanDir& p, bool reverse, int seqlen,
                                          int dim, int dstate, float (*s_B)[kMaxN],
                                          float (*s_C)[kMaxN],
                                          float (*s_dt)[kDtRows][kWarpSize + 1] = nullptr) {
  static_assert(!kStage || !kFdt, "the stage form is off in the fuse_dt form");
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
  T* out = static_cast<T*>(p.out) + static_cast<long long>(b) * seqlen * dim + dc;
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
  const float dskip = p.Dskip[dc];

  auto step_of = [&](int i) { return reverse ? seqlen - 1 - i : i; };
  // Element steps between consecutive processed steps (negative reversed).
  const int dir = reverse ? -1 : 1;
  const long long dt_step = dir * p.dt_sl, u_step = dir * p.u_sl, z_step = dir * p.z_sl;
  auto load_sub = [&](SubStreams& s, int i0) {
    const long long t0 = step_of(i0);
    const T* pd = dt + t0 * p.dt_sl;
    const T* pu = u + t0 * p.u_sl;
    const T* pz = z + t0 * p.z_sl;
    if constexpr (kFdt) {
      // A new tile every kDtRows steps; the rows it replaces are in
      // registers already (this sub-chunk's cur was loaded from them).
      const int warp = tid / kWarpSize;
      if (i0 % kDtRows == 0) {
        __syncwarp();
        dt_tile<T>(p, reverse, seqlen, dim, b, i0, blockIdx.x * kThreads + warp * kWarpSize,
                   s_dt[warp]);
        __syncwarp();
      }
    }
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const bool in = i0 + j < seqlen;  // past the end: zeros, unused
      if constexpr (kFdt) {
        s.dt[j] = in ? s_dt[tid / kWarpSize][i0 % kDtRows + j][tid % kWarpSize] : 0.0f;
      } else {
        s.dt[j] = in ? aum::to_float(pd[j * dt_step]) : 0.0f;
      }
      s.u[j] = in ? aum::to_float(pu[j * u_step]) : 0.0f;
      s.z[j] = in ? aum::to_float(pz[j * z_step]) : 0.0f;
    }
  };
  // The direct kernel reads B_t/C_t in 16-byte vectors where every row is
  // whole and aligned (N = 16 and the mixer's layout), else value by value.
  const bool rows16 = kDirect && dstate == kMaxN && aum::aligned16(Bm) &&
                      aum::aligned16(Cm) && p.B_sl * sizeof(T) % 16 == 0 &&
                      p.C_sl * sizeof(T) % 16 == 0;

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
        __syncthreads();  // the previous chunk's readers are done with s_B/s_C
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
          out[static_cast<long long>(step_of(i0 + j)) * dim] =
              aum::from_float<T>(fmaf(dskip, cur.u[j], y) * aum::silu_fast(cur.z[j]));
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

// Both directions of one bidirectional layer: blockIdx.z 0 forward, 1 reverse.
template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads, kSave ? kMinBlocks : kMinBlocksWide)
scan_dual_fwd_kernel(const ScanDir fwd, const ScanDir rev, int seqlen, int dim, int dstate) {
  __shared__ __align__(16) float s_B[kChunk][kMaxN];
  __shared__ __align__(16) float s_C[kChunk][kMaxN];
  const bool reverse = blockIdx.z == 1;
  scan_walk<T, kSave, false, false>(reverse ? rev : fwd, reverse, seqlen, dim, dstate, s_B,
                                    s_C);
}

// The fuse_dt form (eval): dt formed from dtr, Wt and bias in the kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocksWide)
scan_dual_fdt_fwd_kernel(const ScanDir fwd, const ScanDir rev, int seqlen, int dim,
                         int dstate) {
  __shared__ __align__(16) float s_B[kChunk][kMaxN];
  __shared__ __align__(16) float s_C[kChunk][kMaxN];
  __shared__ float s_dt[kWarps][kDtRows][kWarpSize + 1];  // +1: fewer bank conflicts
  const bool reverse = blockIdx.z == 1;
  scan_walk<T, false, false, false, true>(reverse ? rev : fwd, reverse, seqlen, dim, dstate,
                                          s_B, s_C, s_dt);
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
  scan_walk<T, kSave, false, true>(reverse ? rev : fwd, reverse, seqlen, dim, dstate,
                                   nullptr, nullptr);
}

// One direction, reversed or not at run time.
template <typename T, bool kSave, bool kState>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_single_fwd_kernel(const ScanDir p, int reverse, int seqlen, int dim, int dstate) {
  __shared__ __align__(16) float s_B[kChunk][kMaxN];
  __shared__ __align__(16) float s_C[kChunk][kMaxN];
  scan_walk<T, kSave, kState, false>(p, reverse != 0, seqlen, dim, dstate, s_B, s_C);
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
    scan_dual_fdt_fwd_kernel<T><<<grid, kThreads, 0, s>>>(fwd, rev, seqlen, dim, dstate);
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
  return p.dtr == nullptr || p.Wt == nullptr || p.bias == nullptr || p.rank < 1 ||
         p.rank > kMaxRank;
}

int dual_fwd(const ScanDir* fwd, const ScanDir* rev, DualKind kind, int batch, int seqlen,
             int dim, int dstate, int dtype, void* stream) {
  if (bad_sizes(batch, seqlen, dim, dstate) ||
      (fwd->xb == nullptr) != (rev->xb == nullptr) || fwd->x0 != nullptr ||
      fwd->xfin != nullptr || rev->x0 != nullptr || rev->xfin != nullptr ||
      (kind == DualKind::kFdt && (fwd->xb != nullptr || bad_fold(*fwd) || bad_fold(*rev))) ||
      (kind == DualKind::kStage && dtype != 1)) {
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
  AUM_KERNEL(scan_dual_fdt_fwd_kernel<__nv_bfloat16>)
  AUM_KERNEL(scan_dual_fdt_fwd_kernel<float>)
  AUM_KERNEL(scan_dual_stage_fwd_kernel<false>)
  AUM_KERNEL(scan_dual_stage_fwd_kernel<true>)
#undef AUM_KERNEL
  return -1;
}

// dtype: 0 = fp32 streams, 1 = bf16 streams. Both directions save states
// (xb set in both) or neither does; neither carries a state in or out.
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
// and rank (1 .. 64) set in both directions.
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
// (the with_state form) or both null. dtype and the return value as above.
int aum_selective_scan_fwd(const ScanDir* p, int reverse, int batch, int seqlen, int dim,
                           int dstate, int dtype, void* stream) {
  if (bad_sizes(batch, seqlen, dim, dstate) || (p->x0 == nullptr) != (p->xfin == nullptr)) {
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
