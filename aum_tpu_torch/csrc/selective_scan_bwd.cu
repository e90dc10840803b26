// Selective-scan backward, one or both directions in one launch (sm_90a).
//
// Replaces the TPU kernel aum_tpu/ops/selective_scan.py:_bwd_kernel in its
// default dla_mode "xprev" and, under AUM_SCAN_BWD_XMINUS=1 or
// AUM_SCAN_BWD_DBU=1, its modes "xminus" and "dbu" (kXminus: one form for
// both, see adjoint_step in scan_bwd.cuh), with and without its with_state
// form, with fp32 dB/dC partials or, under AUM_SCAN_BWD_BF16_PARTIALS=1,
// bf16 ones (kBf16Part; below); launched
// with both directions it is also the counterpart of _bwd_kernel_dual, which
// gives the same outputs as two _bwd_kernel calls. Per direction, per
// (batch b, channel d), with dt the pre-activated, rounded softplus(delta +
// bias) the forward streamed, g the cotangent of out, and x_t the states of
// the forward (selective_scan.cu):
//
//   a_t  = exp(dt_t A),  y_t = sum_n C_t x_t,  gy = g silu(z)
//   dz   = g (y + D u) sigmoid(z) (1 + z (1 - sigmoid(z)))
//   lam_t = C_t gy_t + a_{t+1} lam_{t+1}           (walked against the scan)
//   dA  += dt lam a x_{t-1},   dD += gy u
//   ddt  = sum_n lam a x_{t-1} A + (sum_n lam B) u
//   du   = gy D + (sum_n lam B) dt
//   dB_t = sum_d lam dt u,     dC_t = sum_d x_t gy
//   ddelta = ddt (1 - exp(-dt))   (sigmoid(delta + bias), from dt alone;
//                                  ddelta = ddt where dt had no softplus)
//   dbias += ddelta               (the fp32 value, before ddelta's cast)
//
// The with_state form (one direction; the backward of a scan that started
// from a carried state x0 and returned its final state) seeds the carry
// with gfin, the final state's cotangent, where a state beyond the last
// processed step would inject it, and writes dx0 = a_first lam_first, the
// carry after the first processed step (position 0 when reversed). Both
// cross as (batch, N, D) fp32, coalesced over channels like xb.
//
// Design: a chain (batch, channel, direction) is split over a group of
// kGroup = 4 lanes, each holding kNL = 4 of its N <= 16 states, so a warp
// covers 8 channels and a block of kWarps = 4 warps 32 neighbouring channels
// of one batch row (grid = (ceil(D / 32), batch, directions)). The chain
// walks the chunks of kChunk steps (the forward's save interval) in reverse
// processing order and restarts each from its saved entry state xb. A
// chunk's 64 x 16 fp32 states do not fit in registers, so the states are
// recomputed on two levels: one walk through the chunk keeps the entry state
// of each sub-chunk of kSub steps in shared memory (the first one's is xb
// itself), then each sub-chunk, last first, is walked again keeping the
// state before every step in shared memory, and the adjoint runs over it
// backwards. The block stages each sub-chunk's dt, u, z and g for its 32
// channels in shared memory (coalesced rows, each element loaded once, not
// once per lane), loading the next sub-chunk's while this one is walked, so
// neither the level-2 walk nor the adjoint waits on memory and the streams
// hold no registers (the level-1 walk reads dt and u itself). The adjoint
// carry stays in registers across chunks. Sums over n (y_t, and the two
// sums of ddt) are taken across the group with two shuffles each. B_t and
// C_t are staged per chunk in shared memory and read as broadcasts. Every exponential is one
// ex2.approx.ftz on the special-function unit (exp2f's range fix-up is three
// more instructions per state and step), and sigmoid(z) one exp2 and one
// reciprocal there. What a step computes once per channel (du, ddelta, dz,
// their gate terms and stores) is spread over the group: each lane keeps
// y + D u and the two sums of ddt of the sub-chunk steps it owns (steps j
// = r * kGroup + q) and forms and writes them after the sub-chunk; dbias
// sums per lane and once across the group at the end.
//
// dB_t and dC_t reduce over channels, which span blocks: each warp sums its
// 8 channels' contributions with a butterfly reduce-scatter over the lanes
// of equal state group (7 shuffles for 8 sums per lane; afterwards the 32
// lanes hold the 2N sums, one each), the block adds its 4 warps' rows in
// shared memory and writes one coalesced row of 32 floats of fp32 partials
// per step, (ceil(D / 32), batch, L, 32), which the wrapper sums over
// blocks in fp32. With bf16 partials each block's row is rounded to bf16
// once it is summed: per block of 32 channels, where the TPU kernel rounds
// per d-tile (its d_block channels), so the two round different sums. dA, dD and dbias reduce over batch and length: each lane sums in
// registers over its length and writes one partial per batch row, summed by
// the wrapper. All sums are fp32; their order differs from the TPU kernel's.
//
// What bounds it: per (b, l, d, n) element and direction the minimal work
// is one exp2 (the recompute of a_t) and about a dozen FP32-pipe
// instructions of the adjoint, against 4 (B,L,D) reads, 3 (B,L,D) writes and
// the fp32 partials, so like the forward it is bound by operations, not
// bytes. Each step is a chain of dependent operations, so the kernel needs
// many warps in flight: splitting N over 4 lanes gives 4x the warps of one
// thread per chain, and 44 KB of shared memory per 4-warp block (bf16
// streams; 46 KB in fp32) leaves 20 warps per SM (registers capped to 96 to
// match, with some spills). It still evaluates each a_t three times (both
// recompute walks and the adjoint): measured on an H100, keeping the
// level-2 states in registers instead (28 KB per block) costs more in
// registers and spills than it saves, at 3, 4 or 5 blocks per SM.
//
// Built ungated (AUM_SCAN_GATED=0: the library "selective_scan_bwd_sliced")
// it is the backward of one slice of 16 states (scan_bwd.cuh says what
// that form reads and writes), every form above included.

#include <cstdint>
#include <type_traits>

#include "scan_bwd.cuh"

namespace {

using namespace aum::bwd;

constexpr int kWarps = 4;                    // warps per block
constexpr int kThreads = kWarp * kWarps;
constexpr int kChanPerBlock = kChanPerWarp * kWarps;  // 32, one partial row
constexpr int kNSub = kChunk / kSub;
// 5 blocks per SM: what the shared memory allows, with registers capped to
// match (96, some bytes of spills; measured faster than 4 blocks at 128).
constexpr int kMinBlocks = 5;

constexpr int kStreams = 4;  // dt, u, z, g
// Elements of one sub-chunk's streams each thread stages.
constexpr int kStagePer = kStreams * kSub * kChanPerBlock / kThreads;
static_assert(kStreams * kSub * kChanPerBlock % kThreads == 0, "whole staging rounds");

// kState: the with_state form (gfin seeds the carry, dx0 is written);
// kSoftplus: dt came through the softplus; kXminus: the x-minus adjoint;
// kBf16Part: bf16 dB/dC partials.
template <typename T, bool kState, bool kSoftplus, bool kXminus = false, bool kBf16Part = false>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_bwd_kernel(const ScanBwdArgs args, int batch, int seqlen, int dim, int dstate) {
  using Part = std::conditional_t<kBf16Part, __nv_bfloat16, float>;
  using Out = std::conditional_t<aum::kGated, T, float>;
  __shared__ __align__(16) float s_B[kChunk][kMaxN];
  __shared__ __align__(16) float s_C[kChunk][kMaxN];
  // Entry states of sub-chunks 1 .. kNSub-1 (sub-chunk 0 starts from xb).
  __shared__ float s_sub[kNSub - 1][kNL][kThreads];
  __shared__ float s_x[kSub][kNL][kThreads];     // state before each step of a sub-chunk
  __shared__ float s_dbc[kSub][kWarps][kRow];    // each warp's dB/dC sums per step
  // dt, u, z, g of the sub-chunk being walked, for the block's channels.
  __shared__ T s_st[kStreams][kSub][kChanPerBlock];

  const ScanBwdDir& p = args.dir[blockIdx.z];
  const bool reverse = p.reverse != 0;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int q = lane % kGroup;  // this lane's states: n = q * kNL + k
  const int ch = lane / kGroup;
  const int b = blockIdx.y;
  const int d = blockIdx.x * kChanPerBlock + warp * kChanPerWarp + ch;
  const bool active = d < dim;
  const int dc = active ? d : 0;  // inactive channels compute on zeros
  const int n0 = q * kNL;
  const int row_pos = row_position(ch, n0);

  const T* u = static_cast<const T*>(p.u) + b * p.u_sb + dc;
  const T* dt = static_cast<const T*>(p.dt) + b * p.dt_sb + dc;
  const T* Bm = static_cast<const T*>(p.B) + b * p.B_sb;
  const T* Cm = static_cast<const T*>(p.C) + b * p.C_sb;
  const long long row = static_cast<long long>(b) * seqlen * dim + dc;
  Out* du = static_cast<Out*>(p.du) + row;
  Out* ddelta = static_cast<Out*>(p.ddelta) + row;
  Out* dz = aum::kGated || p.dz != nullptr ? static_cast<Out*>(p.dz) + row : nullptr;
  Part* dbc = static_cast<Part*>(p.dbc_part) +
              (static_cast<long long>(blockIdx.x) * batch + b) * seqlen * kRow;
  const int n_chunks = (seqlen + kChunk - 1) / kChunk;
  const long long state_row = (static_cast<long long>(b) * dstate + n0) * dim + dc;  // [b, n0, d]

  float A[kNL], lam[kNL], dA[kNL];
  bool has_n[kNL];
#pragma unroll
  for (int k = 0; k < kNL; ++k) {
    has_n[k] = active && n0 + k < dstate;
    A[k] = has_n[k] ? p.A[static_cast<long long>(d) * dstate + n0 + k] : 0.0f;
    // a_{t+1} lam_{t+1}: beyond the last processed step, the final state's
    // cotangent (with_state) or zero.
    lam[k] = (kState && has_n[k]) ? p.gfin[state_row + static_cast<long long>(k) * dim] : 0.0f;
    dA[k] = 0.0f;
  }
  const float dskip = aum::kGated && active ? p.Dskip[d] : 0.0f;
  float dD = 0.0f, dbias = 0.0f;
  // The ungated build without z: no gate, and the z stream staged from g.
  const bool gate = aum::kGated || p.z != nullptr;

  auto step_of = [&](int i) { return reverse ? seqlen - 1 - i : i; };
  // The block's streams of the sub-chunk at processed index i0 (zeros past
  // the end or the last channel): each thread loads kStagePer of them, to
  // be stored into s_st once its readers are done.
  const int chb = warp * kChanPerWarp + ch;  // this lane's channel in the block
  const int d0 = blockIdx.x * kChanPerBlock;
  const T* st_base[kStreams] = {
      static_cast<const T*>(p.dt) + b * p.dt_sb + d0,
      static_cast<const T*>(p.u) + b * p.u_sb + d0,
      gate ? static_cast<const T*>(p.z) + b * p.z_sb + d0
           : static_cast<const T*>(p.g) + b * p.g_sb + d0,
      static_cast<const T*>(p.g) + b * p.g_sb + d0};
  const long long st_sl[kStreams] = {p.dt_sl, p.u_sl, gate ? p.z_sl : p.g_sl, p.g_sl};
  auto load_stage = [&](T (&v)[kStagePer], int i0) {
#pragma unroll
    for (int r = 0; r < kStagePer; ++r) {
      const int e = tid + r * kThreads;
      const int k = e / (kSub * kChanPerBlock);
      const int j = e / kChanPerBlock % kSub;
      const int cc = e % kChanPerBlock;
      const bool in = i0 + j < seqlen && d0 + cc < dim;
      const long long t = step_of(min(i0 + j, seqlen - 1));
      v[r] = in ? st_base[k][t * st_sl[k] + cc] : aum::from_float<T>(0.0f);
    }
  };
  auto store_stage = [&](const T (&v)[kStagePer]) {
#pragma unroll
    for (int r = 0; r < kStagePer; ++r) {
      const int e = tid + r * kThreads;
      s_st[e / (kSub * kChanPerBlock)][e / kChanPerBlock % kSub][e % kChanPerBlock] = v[r];
    }
  };
  auto st = [&](int k, int j) { return aum::to_float(s_st[k][j][chb]); };
  {
    T v[kStagePer];
    load_stage(v, (seqlen - 1) / kSub * kSub);  // the first sub-chunk processed
    store_stage(v);  // read after the first chunk's staging barriers
  }

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int c0 = c * kChunk;
    const int len = min(kChunk, seqlen - c0);
    __syncthreads();  // every thread is done with the previous chunk's s_B/s_C
    // Staged with zeros beyond dstate, so every lane reads kNL values.
    for (int idx = tid; idx < len * kMaxN; idx += kThreads) {
      const int i = idx / kMaxN;
      const int n = idx - i * kMaxN;
      const int t = step_of(c0 + i);
      s_B[i][n] = n < dstate ? aum::to_float(Bm[t * p.B_sl + n]) : 0.0f;
      s_C[i][n] = n < dstate ? aum::to_float(Cm[t * p.C_sl + n]) : 0.0f;
    }
    __syncthreads();

    // Level 1: walk the chunk from its saved entry state, keeping the entry
    // state of every sub-chunk.
    float x[kNL];
    const float* xb = p.xb + ((static_cast<long long>(b) * n_chunks + c) * dstate + n0) * dim + dc;
#pragma unroll
    for (int k = 0; k < kNL; ++k) x[k] = has_n[k] ? xb[static_cast<long long>(k) * dim] : 0.0f;
    const int n_sub = (len + kSub - 1) / kSub;
    for (int s = 0; s < n_sub; ++s) {
      if (s > 0) {
#pragma unroll
        for (int k = 0; k < kNL; ++k) s_sub[s - 1][k][tid] = x[k];
      }
      if (s + 1 == n_sub) break;
      float dtr[kSub], ur[kSub];  // a full sub-chunk: it is not the last
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int t = step_of(c0 + s * kSub + j);
        dtr[j] = load(dt, t * p.dt_sl, active);
        ur[j] = load(u, t * p.u_sl, active);
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j) advance(x, A, &s_B[s * kSub + j][n0], dtr[j], ur[j]);
    }

    for (int s = n_sub - 1; s >= 0; --s) {
      const int i0 = s * kSub;
      const int slen = min(kSub, len - i0);
      // The next sub-chunk processed (maybe in the chunk before) is loaded
      // while this one is walked, and staged after the first barrier below.
      T nxt[kStagePer];
      if (c0 + i0 > 0) load_stage(nxt, c0 + i0 - kSub);
      // Level 2: the state before every step of this sub-chunk.
#pragma unroll
      for (int k = 0; k < kNL; ++k) {
        x[k] = s > 0 ? s_sub[s - 1][k][tid]
                     : (has_n[k] ? xb[static_cast<long long>(k) * dim] : 0.0f);
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        if (j < slen) {
#pragma unroll
          for (int k = 0; k < kNL; ++k) {
            s_x[j][k][tid] = x[k];
          }
          if (j + 1 < slen) advance(x, A, &s_B[i0 + j][n0], st(0, j), st(1, j));
        }
      }

      // The adjoint, against the scan's direction.
      OwnSteps own;
#pragma unroll
      for (int j = kSub - 1; j >= 0; --j) {
        if (j >= slen) continue;
        s_dbc[j][warp][row_pos] = adjoint_step<kXminus>(
            j, &s_x[j][0][tid], kThreads, &s_B[i0 + j][n0], &s_C[i0 + j][n0], A, lam, dA, dD,
            own, st(0, j), st(1, j), st(2, j), st(3, j), dskip, lane, gate);
      }
      auto streams = [&](int j, float& dtv, float& uv, float& zv, float& gv) {
        dtv = st(0, j);
        uv = st(1, j);
        zv = st(2, j);
        gv = st(3, j);
      };
      write_own<T, kSoftplus>(own, streams, du, ddelta, dz, c0 + i0, slen, seqlen, reverse,
                              dim, dskip, active, q, dbias);
      // The block's dB/dC row of each step: the sum of its warps' rows.
      __syncthreads();
      for (int idx = tid; idx < slen * kRow; idx += kThreads) {
        const int j = idx / kRow;
        const int r = idx - j * kRow;
        const int t = step_of(c0 + i0 + j);
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += s_dbc[j][w][r];
        dbc[static_cast<long long>(t) * kRow + r] = aum::from_float<Part>(sum);
      }
      if (c0 + i0 > 0) store_stage(nxt);  // every reader of s_st passed the barrier
      __syncthreads();  // s_dbc is free, s_st holds the next sub-chunk
    }
  }

  dbias = group_sum(dbias);  // each lane summed the steps it wrote
#pragma unroll
  for (int k = 0; k < kNL; ++k) {
    if (has_n[k]) {
      p.dA_part[(static_cast<long long>(b) * dstate + n0 + k) * dim + d] = dA[k];
      // After the first processed step lam = a_first lam_first = dL/dx0.
      if (kState) p.dx0[state_row + static_cast<long long>(k) * dim] = lam[k];
    }
  }
  if (aum::kGated && active && q == 0) {
    p.dD_part[static_cast<long long>(b) * dim + d] = dD;
    p.dbias_part[static_cast<long long>(b) * dim + d] = dbias;
  }
}

// f(std::true_type) or f(std::false_type): a run-time flag as a template one.
template <typename F>
void with_flag(bool on, F f) {
  if (on) {
    f(std::true_type{});
  } else {
    f(std::false_type{});
  }
}

template <typename T>
void launch(const ScanBwdArgs& args, int ndir, int batch, int seqlen, int dim, int dstate,
            cudaStream_t s) {
  const ScanBwdDir& p = args.dir[0];
  const dim3 grid((dim + kChanPerBlock - 1) / kChanPerBlock, batch, ndir);
  with_flag(p.gfin != nullptr, [&](auto state) {
    with_flag(p.softplus != 0, [&](auto softplus) {
      with_flag(p.xminus != 0, [&](auto xminus) {
        with_flag(p.bf16_partials != 0, [&](auto part) {
          scan_bwd_kernel<T, decltype(state)::value, decltype(softplus)::value,
                          decltype(xminus)::value, decltype(part)::value>
              <<<grid, kThreads, 0, s>>>(args, batch, seqlen, dim, dstate);
        });
      });
    });
  });
}

}  // namespace

extern "C" {

// The chunk length of the entry states this kernel restarts from, and the
// channels of one dB/dC partial row (dbc_part's first axis is ceil(D / it)).
int aum_scan_bwd_state_chunk() { return kChunk; }
int aum_scan_bwd_block_channels() { return kChanPerBlock; }

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
  AUM_KERNEL(scan_bwd_kernel<__nv_bfloat16, false, true>)
  AUM_KERNEL(scan_bwd_kernel<__nv_bfloat16, false, false>)
  AUM_KERNEL(scan_bwd_kernel<__nv_bfloat16, true, true>)
  AUM_KERNEL(scan_bwd_kernel<__nv_bfloat16, true, false>)
  AUM_KERNEL(scan_bwd_kernel<float, false, true>)
  AUM_KERNEL(scan_bwd_kernel<float, false, false>)
  AUM_KERNEL(scan_bwd_kernel<float, true, true>)
  AUM_KERNEL(scan_bwd_kernel<float, true, false>)
  // The opt-in forms (the default's 8 come first): x-minus, bf16 partials,
  // both; each with_state or not, through the softplus or not.
  AUM_KERNEL(scan_bwd_kernel<__nv_bfloat16, false, true, true, false>)
  AUM_KERNEL(scan_bwd_kernel<__nv_bfloat16, false, true, false, true>)
  AUM_KERNEL(scan_bwd_kernel<__nv_bfloat16, false, true, true, true>)
  AUM_KERNEL(scan_bwd_kernel<__nv_bfloat16, true, true, true, false>)
  AUM_KERNEL(scan_bwd_kernel<float, false, true, true, false>)
  AUM_KERNEL(scan_bwd_kernel<float, false, true, false, true>)
  AUM_KERNEL(scan_bwd_kernel<float, false, true, true, true>)
  AUM_KERNEL(scan_bwd_kernel<float, true, true, true, false>)
#undef AUM_KERNEL
  return -1;
}

// ndir directions (1 or 2) from args->dir[0 .. ndir-1]; dtype: 0 = fp32
// streams, 1 = bf16 streams. gfin and dx0 are both set (the with_state
// form, one direction) or both null in every direction; both directions
// share softplus, xminus and bf16_partials. Returns
// cudaGetLastError() after the launch (0 on success); a refused launch
// never runs.
int aum_selective_scan_bwd(const ScanBwdArgs* args, int ndir, int batch, int seqlen,
                           int dim, int dstate, int dtype, void* stream) {
  if (ndir < 1 || ndir > 2 || dstate < 1 || dstate > kMaxN || batch < 1 || seqlen < 1 ||
      dim < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool state = args->dir[0].gfin != nullptr;
  for (int i = 0; i < ndir; ++i) {
    const ScanBwdDir& p = args->dir[i];
    if ((p.gfin != nullptr) != state || (p.dx0 != nullptr) != state || (state && ndir != 1) ||
        p.softplus != args->dir[0].softplus || p.xminus != args->dir[0].xminus ||
        p.bf16_partials != args->dir[0].bf16_partials) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(*args, ndir, batch, seqlen, dim, dstate, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(*args, ndir, batch, seqlen, dim, dstate, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

AUM_DEFINE_ERROR_STRING(aum_scan_bwd_error_string)
