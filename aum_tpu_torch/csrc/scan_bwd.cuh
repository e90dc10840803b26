// What the two selective-scan backward kernels share (sm_90a): the operand
// struct of their C entries, the lane layout of a chain, the recurrence and
// adjoint steps, and the warp-level sums. selective_scan_bwd.cu recomputes
// a chunk's states on two levels; selective_scan_bwd_fused.cu once. See each
// source for its design.
#pragma once

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
  void* dbc_part;      // (ceil(D / channels per block), batch, L, 32): [n] dB, [16 + n] dC;
                       // fp32, or bf16 with bf16_partials
  const float* gfin;   // (batch, N, D) fp32 cotangent of the final state, or null
  float* dx0;          // (batch, N, D) fp32 grad of the starting state, or null
  long long u_sb, u_sl;
  long long dt_sb, dt_sl;
  long long z_sb, z_sl;
  long long B_sb, B_sl;
  long long C_sb, C_sl;
  long long g_sb, g_sl;
  int reverse;
  int softplus;  // 1: ddelta = ddt (1 - exp(-dt)), through the softplus; 0: ddelta = ddt
  int xminus;         // 1: K2's x-minus adjoint (dla_mode "xminus" / "dbu"); K2 only
  int bf16_partials;  // 1: dbc_part rows written in bf16 (AUM_SCAN_BWD_BF16_PARTIALS=1)
};

struct ScanBwdArgs {
  ScanBwdDir dir[2];
};

namespace aum {
namespace bwd {

constexpr int kWarp = 32;
constexpr int kGroup = 4;                    // lanes per chain
constexpr int kMaxN = 16;
constexpr int kNL = kMaxN / kGroup;          // states per lane
constexpr int kChanPerWarp = kWarp / kGroup;  // 8
constexpr int kChunk = 64;  // the forward's state-save interval (selective_scan.cu)
constexpr int kSub = 8;     // steps whose per-step streams are loaded at once
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRow = 2 * kMaxN;  // floats per partial row: N dB then N dC sums
static_assert(2 * kNL == kChanPerWarp, "the reduce-scatter leaves one sum per lane");
static_assert(kRow == kWarp, "a warp's lanes hold one row");

template <typename T>
__device__ __forceinline__ float load(const T* p, long long offset, bool active) {
  return active ? aum::to_float(p[offset]) : 0.0f;
}

// One step of the forward recurrence on this lane's states n = q * kNL + k.
// Row: anything that bt[k] reads B_t[n0 + k] from as a float (K2 passes a
// pointer into its fp32 rows, the fused kernel the values themselves).
template <typename Row>
__device__ __forceinline__ void advance(float (&x)[kNL], const float (&A)[kNL], Row bt,
                                       float dtv, float uv) {
  const float dtl = dtv * kLog2e;
  const float dtu = dtv * uv;
#pragma unroll
  for (int k = 0; k < kNL; ++k) x[k] = aum::exp2_sfu(dtl * A[k]) * x[k] + dtu * bt[k];
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

// Where a lane's channel sum lands in the row of 32: dB_n at n, dC_n at 16 + n.
__device__ __forceinline__ int row_position(int ch, int n0) {
  return ch < kNL ? n0 + ch : kMaxN + n0 + ch - kNL;
}

// The step-wise outputs of the sub-chunk steps a lane writes: each lane of
// a chain writes steps j = r * kGroup + q of a sub-chunk of kSub, so the
// gate grads and the stores are spread over the group, not repeated by it.
constexpr int kOwn = kSub / kGroup;
static_assert(kSub % kGroup == 0, "every lane writes the same number of steps");
struct OwnSteps {
  float yd[kOwn];    // y_t + D u_t
  float gdtu[kOwn];  // sum_n lam B
  float ddt[kOwn];   // the grad of dt before the softplus
};

// One adjoint step at processed step t, against the scan's direction, on
// this lane's states, from a_t (a[k]) and the state before the step
// (xprev[k]): recomputes x_t and y_t; lam_t = C_t gy_t + lam, and on return
// lam = a_t lam_t (the carry to the step before); adds to dA and dD. Step j
// of the sub-chunk records y_t + D u_t and the two sums of ddt in `own` on
// the lane that writes it (write_own forms du, ddelta, dz from them).
// Returns this lane's share of the step's dB/dC row (see
// channel_reduce_scatter). Both backward kernels run this one step (through
// adjoint_step, or with a_t from registers), so they cannot drift apart.
// j must be a constant after unrolling: it indexes registers. bt and ct:
// this lane's kNL values of B_t and C_t, as in advance; xprev: anything that
// xprev[k] reads a state from.
// kXminus (K2 under AUM_SCAN_BWD_XMINUS=1 or AUM_SCAN_BWD_DBU=1): the grad
// of dt A as lam_t (x_t - (dt u) B_t) from the recomputed x_t, in place of
// lam_t a_t x_{t-1}, equal up to fp32 rounding (a_t x_{t-1} = x_t - dBu_t).
// The TPU kernel's two modes differ only in where dBu = (dt u) B is formed
// (staged in the chunk's prologue, or again in its epilogue): the same fp32
// products, so one form serves both.
template <bool kXminus = false, typename Row, typename Prev>
__device__ __forceinline__ float adjoint_from(
    int j, const float (&a)[kNL], Prev xprev, Row bt, Row ct, const float (&A)[kNL],
    float (&lam)[kNL], float (&dA)[kNL], float& dD, OwnSteps& own, float dtv, float uv,
    float zv, float gv, float dskip, int lane) {
  const float dtu = dtv * uv;
  float xt[kNL];
  float y = 0.0f;
#pragma unroll
  for (int k = 0; k < kNL; ++k) {
    xt[k] = a[k] * xprev[k] + dtu * bt[k];
    y += ct[k] * xt[k];
  }
  const float gy = gv * zv * aum::sigmoid_fast(zv);
  dD += gy * uv;

  float v[2 * kNL];
  float dla_a = 0.0f, gdtu = 0.0f;
#pragma unroll
  for (int k = 0; k < kNL; ++k) {
    const float l = ct[k] * gy + lam[k];
    float dla;
    if constexpr (kXminus) {
      dla = l * (xt[k] - dtu * bt[k]);
    } else {
      dla = l * a[k] * xprev[k];  // read again: fewer live registers
    }
    dA[k] += dtv * dla;
    dla_a += dla * A[k];
    gdtu += l * bt[k];
    v[k] = l * dtu;           // dB_t[n], this channel's share
    v[kNL + k] = xt[k] * gy;  // dC_t[n], this channel's share
    lam[k] = a[k] * l;
  }
  y = group_sum(y);
  gdtu = group_sum(gdtu);
  dla_a = group_sum(dla_a);
  if (lane % kGroup == j % kGroup) {
    own.yd[j / kGroup] = y + dskip * uv;
    own.gdtu[j / kGroup] = gdtu;
    own.ddt[j / kGroup] = dla_a + gdtu * uv;
  }
  channel_reduce_scatter(v, lane);
  return v[0];
}

// The states before a step, kNL of them xstride floats apart in shared memory.
struct Strided {
  const float* p;
  int stride;
  __device__ __forceinline__ float operator[](int k) const { return p[k * stride]; }
};

// adjoint_from with a_t evaluated here and the state before the step read
// from xprev[k * xstride].
template <bool kXminus = false, typename Row>
__device__ __forceinline__ float adjoint_step(
    int j, const float* xprev, int xstride, Row bt, Row ct,
    const float (&A)[kNL], float (&lam)[kNL], float (&dA)[kNL], float& dD, OwnSteps& own,
    float dtv, float uv, float zv, float gv, float dskip, int lane) {
  const float dtl = dtv * kLog2e;
  float a[kNL];
#pragma unroll
  for (int k = 0; k < kNL; ++k) a[k] = aum::exp2_sfu(dtl * A[k]);
  return adjoint_from<kXminus>(j, a, Strided{xprev, xstride}, bt, ct, A, lam, dA, dD, own,
                               dtv, uv, zv, gv, dskip, lane);
}

// This lane's share of a sub-chunk's du, ddelta and dz (its steps j = r *
// kGroup + q, j < slen, at processed index i0 + j), and their ddelta in
// dbias. streams(j, dt, u, z, g) gives step j's per-step streams.
// kSoftplus: dt came through the softplus (ddelta = ddt (1 - exp(-dt))).
template <typename T, bool kSoftplus, typename StepStreams>
__device__ __forceinline__ void write_own(
    const OwnSteps& own, StepStreams streams, T* du, T* ddelta, T* dz, int i0, int slen,
    int seqlen, bool reverse, int dim, float dskip, bool active, int q, float& dbias) {
#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
    const int j = r * kGroup + q;
    if (!active || j >= slen) continue;
    const int t = reverse ? seqlen - 1 - (i0 + j) : i0 + j;
    float dtv, uv, zv, gv;
    streams(j, dtv, uv, zv, gv);
    const float sig = aum::sigmoid_fast(zv);
    const float gy = gv * zv * sig;
    // sigmoid(delta + bias) = 1 - exp(-dt), in the plain version's form
    const float dd = kSoftplus ? own.ddt[r] * (1.0f - aum::exp2_sfu(-dtv * kLog2e))
                               : own.ddt[r];
    dbias += dd;
    const long long o = static_cast<long long>(t) * dim;
    du[o] = aum::from_float<T>(gy * dskip + own.gdtu[r] * dtv);
    ddelta[o] = aum::from_float<T>(dd);
    dz[o] = aum::from_float<T>(gv * own.yd[r] * (sig * (1.0f + zv * (1.0f - sig))));
  }
}

}  // namespace bwd
}  // namespace aum
