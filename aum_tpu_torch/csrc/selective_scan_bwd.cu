// Selective-scan backward, one or both directions in one launch (sm_90a).
//
// Replaces the TPU kernel aum_tpu/ops/selective_scan.py:_bwd_kernel in its
// default configuration (dla_mode "xprev", no carried-in state); launched
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
//   ddelta = ddt (1 - exp(-dt))   (sigmoid(delta + bias), from dt alone)
//   dbias += ddelta               (the fp32 value, before ddelta's cast)
//
// Design: a chain (batch, channel, direction) is split over a group of
// kGroup = 4 lanes, each holding kNL = 4 of its N <= 16 states, so a warp
// covers 8 channels and a block of kWarps = 4 warps 32 neighbouring channels
// of one batch row (grid = (ceil(D / 32), batch, directions)). The chain
// walks the chunks of kChunk steps (the forward's save interval) in reverse
// processing order and restarts each from its saved entry state xb. A
// chunk's 64 x 16 fp32 states do not fit in registers, so the states are
// recomputed on two levels: one walk through the chunk keeps the entry state
// of each sub-chunk of kSub steps in shared memory, then each sub-chunk,
// last first, is walked again keeping the state before every step in shared
// memory, and the adjoint runs over it backwards. Each sub-chunk's per-step
// streams are loaded together before they are used. The adjoint carry stays
// in registers across chunks. Sums over n (y_t, and the two sums of ddt) are
// taken across the group with two shuffles each. B_t and C_t are staged per
// chunk in shared memory and read as broadcasts.
//
// dB_t and dC_t reduce over channels, which span blocks: each warp sums its
// 8 channels' contributions with a butterfly reduce-scatter over the lanes
// of equal state group (7 shuffles for 8 sums per lane; afterwards the 32
// lanes hold the 2N sums, one each), the block adds its 4 warps' rows in
// shared memory and writes one coalesced row of 32 floats of fp32 partials
// per step, (ceil(D / 32), batch, L, 32), which the wrapper sums over
// blocks. dA, dD and dbias reduce over batch and length: each lane sums in
// registers over its length and writes one partial per batch row, summed by
// the wrapper. All sums are fp32; their order differs from the TPU kernel's.
//
// What bounds it: per (b, l, d, n) element and direction the minimal work
// is one exp2 (the recompute of a_t) and about a dozen FP32-pipe
// instructions of the adjoint, against 4 (B,L,D) reads, 3 (B,L,D) writes and
// the fp32 partials, so like the forward it is bound by operations, not
// bytes. Each step is a chain of dependent operations, so the kernel needs
// many warps in flight: splitting N over 4 lanes gives 4x the warps of one
// thread per chain, and 44 KB of shared memory per 4-warp block leaves 20
// warps per SM (with registers capped to fit). It still evaluates each a_t
// three times (both recompute walks and the adjoint).

#include <cstdint>

#include "common.cuh"

// One direction's operands and outputs. Strides are in elements; every
// (B, L, D) or (B, L, N) stream has channel stride 1.
struct ScanBwdDir {
  const void* u;
  const void* dt;
  const void* z;
  const void* B;
  const void* C;
  const float* A;      // (D, N) fp32, contiguous
  const float* Dskip;  // (D,) fp32
  const void* g;       // cotangent of out
  const float* xb;     // (batch, ceil(L / kChunk), N, D) fp32 entry states
  void* du;            // (batch, L, D), contiguous, stream dtype
  void* ddelta;        // (batch, L, D), contiguous, stream dtype
  void* dz;            // (batch, L, D), contiguous, stream dtype
  float* dA_part;      // (batch, N, D)
  float* dD_part;      // (batch, D)
  float* dbias_part;   // (batch, D)
  float* dbc_part;     // (ceil(D / 32), batch, L, 32): [n] dB, [16 + n] dC
  long long u_sb, u_sl;
  long long dt_sb, dt_sl;
  long long z_sb, z_sl;
  long long B_sb, B_sl;
  long long C_sb, C_sl;
  long long g_sb, g_sl;
  int reverse;
};

struct ScanBwdArgs {
  ScanBwdDir dir[2];
};

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;                    // warps per block
constexpr int kThreads = kWarp * kWarps;
constexpr int kGroup = 4;                    // lanes per chain
constexpr int kMaxN = 16;
constexpr int kNL = kMaxN / kGroup;          // states per lane
constexpr int kChanPerWarp = kWarp / kGroup;  // 8
constexpr int kChanPerBlock = kChanPerWarp * kWarps;  // 32, one partial row
constexpr int kChunk = 64;  // the forward's state-save interval (selective_scan.cu)
constexpr int kSub = 8;     // steps whose states are held at once
constexpr int kNSub = kChunk / kSub;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRow = 2 * kMaxN;  // floats per partial row: N dB then N dC sums
static_assert(2 * kNL == kChanPerWarp, "the reduce-scatter leaves one sum per lane");
static_assert(kRow == kWarp, "a warp's lanes hold one row");

template <typename T>
__device__ __forceinline__ float load(const T* p, long long offset, bool active) {
  return active ? aum::to_float(p[offset]) : 0.0f;
}

// One step of the forward recurrence on this lane's states n = q * kNL + k.
__device__ __forceinline__ void advance(float (&x)[kNL], const float (&A)[kNL],
                                        const float* bt, float dtv, float uv) {
  const float dtl = dtv * kLog2e;
  const float dtu = dtv * uv;
#pragma unroll
  for (int k = 0; k < kNL; ++k) x[k] = exp2f(dtl * A[k]) * x[k] + dtu * bt[k];
}

// The sum of v over the kGroup lanes of a chain, in every one of them.
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One level of the butterfly over lanes of equal state group: lanes with
// bit kLane set keep the upper half of v[0, 2 kHalf), the others the lower
// half, and each adds its partner's.
template <int kLane, int kHalf>
__device__ __forceinline__ void reduce_level(float (&v)[2 * kNL], int lane) {
  const bool upper = (lane & kLane) != 0;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float send = upper ? v[j] : v[j + kHalf];
    const float keep = upper ? v[j + kHalf] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, kLane);
  }
}

// Sums v[i] over the warp's 8 channels: afterwards v[0] of a lane in
// channel group c (lane / kGroup) holds the sum of v[c]. Every index is a
// compile-time constant, so v stays in registers.
__device__ __forceinline__ void channel_reduce_scatter(float (&v)[2 * kNL], int lane) {
  reduce_level<16, 4>(v, lane);
  reduce_level<8, 2>(v, lane);
  reduce_level<4, 1>(v, lane);
}

// 5 blocks per SM: what the shared memory allows, with registers capped to
// match (96, a few bytes of spills; measured faster than 4 blocks at 128).
template <typename T>
__global__ void __launch_bounds__(kThreads, 5)
scan_bwd_kernel(const ScanBwdArgs args, int batch, int seqlen, int dim, int dstate) {
  __shared__ float s_B[kChunk][kMaxN];
  __shared__ float s_C[kChunk][kMaxN];
  __shared__ float s_sub[kNSub][kNL][kThreads];  // sub-chunk entry states
  __shared__ float s_x[kSub][kNL][kThreads];     // state before each step of a sub-chunk
  __shared__ float s_dbc[kSub][kWarps][kRow];    // each warp's dB/dC sums per step

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
  // Where this lane's channel sum lands in the row of 32: dB_n at n, dC_n at 16 + n.
  const int row_pos = ch < kNL ? n0 + ch : kMaxN + n0 + ch - kNL;

  const T* u = static_cast<const T*>(p.u) + b * p.u_sb + dc;
  const T* dt = static_cast<const T*>(p.dt) + b * p.dt_sb + dc;
  const T* z = static_cast<const T*>(p.z) + b * p.z_sb + dc;
  const T* g = static_cast<const T*>(p.g) + b * p.g_sb + dc;
  const T* Bm = static_cast<const T*>(p.B) + b * p.B_sb;
  const T* Cm = static_cast<const T*>(p.C) + b * p.C_sb;
  const long long row = static_cast<long long>(b) * seqlen * dim + dc;
  T* du = static_cast<T*>(p.du) + row;
  T* ddelta = static_cast<T*>(p.ddelta) + row;
  T* dz = static_cast<T*>(p.dz) + row;
  float* dbc = p.dbc_part + (static_cast<long long>(blockIdx.x) * batch + b) * seqlen * kRow;
  const int n_chunks = (seqlen + kChunk - 1) / kChunk;

  float A[kNL], lam[kNL], dA[kNL];
  bool has_n[kNL];
#pragma unroll
  for (int k = 0; k < kNL; ++k) {
    has_n[k] = active && n0 + k < dstate;
    A[k] = has_n[k] ? p.A[static_cast<long long>(d) * dstate + n0 + k] : 0.0f;
    lam[k] = 0.0f;  // a_{t+1} lam_{t+1}: zero beyond the last processed step
    dA[k] = 0.0f;
  }
  const float dskip = active ? p.Dskip[d] : 0.0f;
  float dD = 0.0f, dbias = 0.0f;

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int c0 = c * kChunk;
    const int len = min(kChunk, seqlen - c0);
    __syncthreads();  // every thread is done with the previous chunk's s_B/s_C
    // Staged with zeros beyond dstate, so every lane reads kNL values.
    for (int idx = tid; idx < len * kMaxN; idx += kThreads) {
      const int i = idx / kMaxN;
      const int n = idx - i * kMaxN;
      const int t = reverse ? seqlen - 1 - (c0 + i) : c0 + i;
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
#pragma unroll
      for (int k = 0; k < kNL; ++k) s_sub[s][k][tid] = x[k];
      if (s + 1 == n_sub) break;
      float dtr[kSub], ur[kSub];  // a full sub-chunk: it is not the last
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int i = s * kSub + j;
        const int t = reverse ? seqlen - 1 - (c0 + i) : c0 + i;
        dtr[j] = load(dt, t * p.dt_sl, active);
        ur[j] = load(u, t * p.u_sl, active);
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j) advance(x, A, &s_B[s * kSub + j][n0], dtr[j], ur[j]);
    }

    for (int s = n_sub - 1; s >= 0; --s) {
      const int i0 = s * kSub;
      const int slen = min(kSub, len - i0);
      float dtr[kSub], ur[kSub], zr[kSub], gr[kSub];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const bool in = active && j < slen;
        const int i = i0 + j;
        const int t = reverse ? seqlen - 1 - (c0 + i) : c0 + i;
        dtr[j] = load(dt, t * p.dt_sl, in);
        ur[j] = load(u, t * p.u_sl, in);
        zr[j] = load(z, t * p.z_sl, in);
        gr[j] = load(g, t * p.g_sl, in);
      }
      // Level 2: the state before every step of this sub-chunk.
#pragma unroll
      for (int k = 0; k < kNL; ++k) x[k] = s_sub[s][k][tid];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        if (j < slen) {
#pragma unroll
          for (int k = 0; k < kNL; ++k) s_x[j][k][tid] = x[k];
          if (j + 1 < slen) advance(x, A, &s_B[i0 + j][n0], dtr[j], ur[j]);
        }
      }

      // The adjoint, against the scan's direction.
#pragma unroll
      for (int j = kSub - 1; j >= 0; --j) {
        if (j >= slen) continue;
        const int i = i0 + j;
        const int t = reverse ? seqlen - 1 - (c0 + i) : c0 + i;
        const float dtv = dtr[j], uv = ur[j], zv = zr[j], gv = gr[j];
        const float dtl = dtv * kLog2e;
        const float dtu = dtv * uv;

        float a[kNL], xt[kNL];
        float y = 0.0f;
#pragma unroll
        for (int k = 0; k < kNL; ++k) {
          a[k] = exp2f(dtl * A[k]);
          xt[k] = a[k] * s_x[j][k][tid] + dtu * s_B[i][n0 + k];
          y += s_C[i][n0 + k] * xt[k];
        }
        y = group_sum(y);
        const float sig = 1.0f / (1.0f + expf(-zv));
        const float gy = gv * zv * sig;
        const float dzv = gv * (y + dskip * uv) * (sig * (1.0f + zv * (1.0f - sig)));
        dD += gy * uv;

        float v[2 * kNL];
        float dla_a = 0.0f, gdtu = 0.0f;
#pragma unroll
        for (int k = 0; k < kNL; ++k) {
          const float l = s_C[i][n0 + k] * gy + lam[k];
          const float dla = l * a[k] * s_x[j][k][tid];
          dA[k] += dtv * dla;
          dla_a += dla * A[k];
          gdtu += l * s_B[i][n0 + k];
          v[k] = l * dtu;             // dB_t[n], this channel's share
          v[kNL + k] = xt[k] * gy;    // dC_t[n], this channel's share
          lam[k] = a[k] * l;
        }
        gdtu = group_sum(gdtu);
        const float ddt = group_sum(dla_a) + gdtu * uv;
        const float dd = ddt * (1.0f - expf(-dtv));
        dbias += dd;
        if (active && q == 0) {
          const long long o = static_cast<long long>(t) * dim;
          du[o] = aum::from_float<T>(gy * dskip + gdtu * dtv);
          ddelta[o] = aum::from_float<T>(dd);
          dz[o] = aum::from_float<T>(dzv);
        }
        channel_reduce_scatter(v, lane);
        s_dbc[j][warp][row_pos] = v[0];
      }
      // The block's dB/dC row of each step: the sum of its warps' rows.
      __syncthreads();
      for (int idx = tid; idx < slen * kRow; idx += kThreads) {
        const int j = idx / kRow;
        const int r = idx - j * kRow;
        const int i = i0 + j;
        const int t = reverse ? seqlen - 1 - (c0 + i) : c0 + i;
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += s_dbc[j][w][r];
        dbc[static_cast<long long>(t) * kRow + r] = sum;
      }
      __syncthreads();  // s_dbc is free for the next sub-chunk
    }
  }

#pragma unroll
  for (int k = 0; k < kNL; ++k) {
    if (has_n[k]) p.dA_part[(static_cast<long long>(b) * dstate + n0 + k) * dim + d] = dA[k];
  }
  if (active && q == 0) {
    p.dD_part[static_cast<long long>(b) * dim + d] = dD;
    p.dbias_part[static_cast<long long>(b) * dim + d] = dbias;
  }
}

}  // namespace

extern "C" {

// The chunk length of the entry states this kernel restarts from.
int aum_scan_bwd_state_chunk() { return kChunk; }

// ndir directions (1 or 2) from args->dir[0 .. ndir-1]; dtype: 0 = fp32
// streams, 1 = bf16 streams. Returns cudaGetLastError() after the launch
// (0 on success); a refused launch never runs.
int aum_selective_scan_bwd(const ScanBwdArgs* args, int ndir, int batch, int seqlen,
                           int dim, int dstate, int dtype, void* stream) {
  if (ndir < 1 || ndir > 2 || dstate < 1 || dstate > kMaxN || batch < 1 || seqlen < 1 ||
      dim < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((dim + kChanPerBlock - 1) / kChanPerBlock, batch, ndir);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    scan_bwd_kernel<float><<<grid, kThreads, 0, s>>>(*args, batch, seqlen, dim, dstate);
  } else if (dtype == 1) {
    scan_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(*args, batch, seqlen, dim, dstate);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

AUM_DEFINE_ERROR_STRING(aum_scan_bwd_error_string)
