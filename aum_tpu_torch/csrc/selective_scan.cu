// Fused bidirectional selective scan, forward (sm_90a).
//
// Replaces the TPU kernel aum_tpu/ops/selective_scan.py:_fwd_kernel_dual in
// its default configuration (fused y-readout, per-step decay), in eval and,
// with saved chunk states, in the train forward. Per direction, per
// (batch b, channel d), with the
// pre-activated dt = softplus(delta + bias) streamed in delta's place:
//
//   x_t  = exp2((dt_t * log2 e) * A[d, :]) * x_{t-1} + (dt_t * u_t) * B_t
//   y_t  = sum_n C_t[n] * x_t[n]
//   out  = (y_t + D[d] * u_t) * silu(z_t)          (cast to u's dtype)
//
// The forward direction walks t = 0 .. L-1, the reverse one t = L-1 .. 0.
// With saved states (the train forward, xb != null) the chain also writes
// its N states at the entry of every chunk of kChunk processed steps to
// xb[b, chunk, n, d] (fp32, coalesced over d): the states the backward
// (selective_scan_bwd.cu) restarts from. Chunk 0's entry state is zero.
//
// Design: one thread owns one (batch, channel, direction) chain and keeps its
// N <= 16 fp32 states in registers, so the state never touches memory. A
// block covers kThreads neighbouring channels of one batch row in one
// direction (grid = (ceil(D / kThreads), batch, 2)); its threads read u, dt,
// z and write out with neighbouring threads on neighbouring addresses. B_t
// and C_t are the same for every channel of a row, so the block stages a
// chunk of kChunk steps of them in shared memory and every thread reads them
// as broadcasts. There is no chunk carry across blocks and no padding of N.
//
// What bounds it: per element of (batch, length, channel, state) and
// direction the chain does one exp2 and four FP32-pipe instructions (two
// multiplies, two FMAs). The special-function units do 16 exp2 per SM per
// clock, against 128 FP32 lanes, so the exponentials outweigh both the FP32
// work and the bytes moved (3 (B,L,D) reads and 2 (B,L,D) writes). This
// kernel runs every exp2 on the SFUs; moving a share of them to the FP32 pipe
// as polynomials would lower that floor by about a quarter (chip_smoke.py
// counts that split in its bound). The available parallelism is batch * channels * 2 chains,
// each a serial dependence over L, so at small batch the card is latency
// bound; splitting N across threads is the next step for speed.

#include <cstdint>

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
  long long u_sb, u_sl;
  long long dt_sb, dt_sl;
  long long z_sb, z_sl;
  long long B_sb, B_sl;
  long long C_sb, C_sl;
};

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;
constexpr int kMaxN = 16;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads)
scan_dual_fwd_kernel(const ScanDir fwd, const ScanDir rev, int seqlen,
                     int dim, int dstate) {
  __shared__ float s_B[kChunk][kMaxN];
  __shared__ float s_C[kChunk][kMaxN];

  const bool reverse = blockIdx.z == 1;
  const ScanDir& p = reverse ? rev : fwd;
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool active = d < dim;

  const T* u = static_cast<const T*>(p.u) + b * p.u_sb + d;
  const T* dt = static_cast<const T*>(p.dt) + b * p.dt_sb + d;
  const T* z = static_cast<const T*>(p.z) + b * p.z_sb + d;
  const T* Bm = static_cast<const T*>(p.B) + b * p.B_sb;
  const T* Cm = static_cast<const T*>(p.C) + b * p.C_sb;
  T* out = static_cast<T*>(p.out) + static_cast<long long>(b) * seqlen * dim + d;

  float a[kMaxN];
  float x[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    a[n] = (active && n < dstate) ? p.A[static_cast<long long>(d) * dstate + n] : 0.0f;
    x[n] = 0.0f;
  }
  const float dskip = active ? p.Dskip[d] : 0.0f;

  for (int c0 = 0; c0 < seqlen; c0 += kChunk) {
    const int len = min(kChunk, seqlen - c0);
    __syncthreads();  // the previous chunk's readers are done with s_B/s_C
    for (int idx = threadIdx.x; idx < len * dstate; idx += kThreads) {
      const int i = idx / dstate;
      const int n = idx - i * dstate;
      const int t = reverse ? seqlen - 1 - (c0 + i) : c0 + i;
      s_B[i][n] = aum::to_float(Bm[t * p.B_sl + n]);
      s_C[i][n] = aum::to_float(Cm[t * p.C_sl + n]);
    }
    __syncthreads();
    if (!active) continue;
    if (kSave) {
      float* xb = p.xb + ((static_cast<long long>(b) * ((seqlen + kChunk - 1) / kChunk)
                           + c0 / kChunk) * dstate) * dim + d;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {  // constant indices keep x in registers
        if (n < dstate) xb[static_cast<long long>(n) * dim] = x[n];
      }
    }
    for (int i = 0; i < len; ++i) {
      const int t = reverse ? seqlen - 1 - (c0 + i) : c0 + i;
      const float dtv = aum::to_float(dt[t * p.dt_sl]);
      const float uv = aum::to_float(u[t * p.u_sl]);
      const float zv = aum::to_float(z[t * p.z_sl]);
      const float dtl = dtv * kLog2e;
      const float dtu = dtv * uv;
      float y = 0.0f;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        if (n < dstate) {
          x[n] = exp2f(dtl * a[n]) * x[n] + dtu * s_B[i][n];
          y += s_C[i][n] * x[n];
        }
      }
      out[static_cast<long long>(t) * dim] =
          aum::from_float<T>((y + dskip * uv) * aum::silu(zv));
    }
  }
}

template <typename T>
void launch(const ScanDir& fwd, const ScanDir& rev, int batch, int seqlen, int dim,
            int dstate, cudaStream_t s) {
  const dim3 grid((dim + kThreads - 1) / kThreads, batch, 2);
  if (fwd.xb != nullptr) {
    scan_dual_fwd_kernel<T, true><<<grid, kThreads, 0, s>>>(fwd, rev, seqlen, dim, dstate);
  } else {
    scan_dual_fwd_kernel<T, false><<<grid, kThreads, 0, s>>>(fwd, rev, seqlen, dim, dstate);
  }
}

}  // namespace

extern "C" {

// The chunk length of the saved states (xb's second axis is ceil(L / it)).
int aum_scan_state_chunk() { return kChunk; }

// dtype: 0 = fp32 streams, 1 = bf16 streams. Both directions save states
// (xb set in both) or neither does. Returns cudaGetLastError() after the
// launch (0 on success); a refused launch never runs.
int aum_selective_scan_dual_fwd(const ScanDir* fwd, const ScanDir* rev,
                                int batch, int seqlen, int dim, int dstate,
                                int dtype, void* stream) {
  if (dstate < 1 || dstate > kMaxN || batch < 1 || seqlen < 1 || dim < 1 ||
      (fwd->xb == nullptr) != (rev->xb == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(*fwd, *rev, batch, seqlen, dim, dstate, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(*fwd, *rev, batch, seqlen, dim, dstate, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

AUM_DEFINE_ERROR_STRING(aum_scan_error_string)
