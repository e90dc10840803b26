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
//   x_t  = exp2((dt_t * log2 e) * A[d, :]) * x_{t-1} + (dt_t * u_t) * B_t
//   y_t  = sum_n C_t[n] * x_t[n]
//   out  = (y_t + D[d] * u_t) * silu(z_t)          (cast to u's dtype)
//
// The forward direction walks t = 0 .. L-1, the reverse one t = L-1 .. 0.
// The walk starts from zero, or from x0[b, n, d] (fp32) with a carried-in
// state. With saved states (xb != null) the chain also writes its N states
// at the entry of every chunk of kChunk processed steps to xb[b, chunk, n, d]
// (fp32, coalesced over d): the states the backward (selective_scan_bwd.cu)
// restarts from; chunk 0's entry state is the starting state. With a final
// state (xfin != null) it writes the state after its last processed step
// (position 0 when reversed) to xfin[b, n, d].
//
// Design: one thread owns one (batch, channel, direction) chain and keeps its
// N <= 16 fp32 states in registers, so the state never touches memory. A
// block covers kThreads neighbouring channels of one batch row in one
// direction (grid = (ceil(D / kThreads), batch, directions)); its threads
// read u, dt, z and write out with neighbouring threads on neighbouring
// addresses. B_t and C_t are the same for every channel of a row, so the
// block stages a chunk of kChunk steps of them in shared memory and every
// thread reads them as broadcasts. The direct kernel does not stage them:
// every thread reads B_t and C_t straight from global memory at every step,
// broadcasts within a warp that L1 or the read-only path serves; it tests
// whether the staging (and its two block barriers per chunk) pays on this
// card. A CUDA loop runs exactly L steps, so
// unlike the TPU kernels (whose blocks overhang the array) nothing is masked.
// There is no chunk carry across blocks and no padding of N. All three
// kernels run one walk, scan_chain, so they cannot drift apart.
//
// What bounds it: per element of (batch, length, channel, state) and
// direction the chain does one exp2 and four FP32-pipe instructions (two
// multiplies, two FMAs). The special-function units do 16 exp2 per SM per
// clock, against 128 FP32 lanes, so the exponentials outweigh both the FP32
// work and the bytes moved (3 (B,L,D) reads and 1 (B,L,D) write per
// direction). This kernel runs every exp2 on the SFUs; moving a share of them
// to the FP32 pipe as polynomials would lower that floor by about a quarter
// (chip_smoke.py counts that split in its bound). The available parallelism
// is batch * channels * directions chains, each a serial dependence over L,
// so at small batch the card is latency bound (one direction at B=8 fills 96
// blocks of 128 threads, fewer than the 132 SMs); splitting N across threads
// is the next step for speed.

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
  const float* x0;     // (batch, N, D) fp32 starting state, or null (zero)
  float* xfin;         // (batch, N, D) fp32 final state, or null
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

// The walk of chain (b, d) of one direction. Every thread of the block calls
// it (the staging of B/C synchronises the block); threads past the last
// channel stage and wait but compute nothing. kDirect reads B/C from global
// memory at every step instead (s_B and s_C unused, no barriers).
template <typename T, bool kSave, bool kState, bool kDirect>
__device__ __forceinline__ void scan_chain(const ScanDir& p, bool reverse, int seqlen,
                                           int dim, int dstate, float (*s_B)[kMaxN],
                                           float (*s_C)[kMaxN]) {
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool active = d < dim;

  const T* u = static_cast<const T*>(p.u) + b * p.u_sb + d;
  const T* dt = static_cast<const T*>(p.dt) + b * p.dt_sb + d;
  const T* z = static_cast<const T*>(p.z) + b * p.z_sb + d;
  const T* Bm = static_cast<const T*>(p.B) + b * p.B_sb;
  const T* Cm = static_cast<const T*>(p.C) + b * p.C_sb;
  T* out = static_cast<T*>(p.out) + static_cast<long long>(b) * seqlen * dim + d;
  const long long state_row = static_cast<long long>(b) * dstate * dim + d;  // [b, 0, d]

  float a[kMaxN];
  float x[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    const bool has_n = active && n < dstate;
    a[n] = has_n ? p.A[static_cast<long long>(d) * dstate + n] : 0.0f;
    x[n] = (kState && has_n) ? p.x0[state_row + static_cast<long long>(n) * dim] : 0.0f;
  }
  const float dskip = active ? p.Dskip[d] : 0.0f;

  for (int c0 = 0; c0 < seqlen; c0 += kChunk) {
    const int len = min(kChunk, seqlen - c0);
    if constexpr (!kDirect) {
      __syncthreads();  // the previous chunk's readers are done with s_B/s_C
      for (int idx = threadIdx.x; idx < len * dstate; idx += kThreads) {
        const int i = idx / dstate;
        const int n = idx - i * dstate;
        const int t = reverse ? seqlen - 1 - (c0 + i) : c0 + i;
        s_B[i][n] = aum::to_float(Bm[t * p.B_sl + n]);
        s_C[i][n] = aum::to_float(Cm[t * p.C_sl + n]);
      }
      __syncthreads();
    }
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
      if constexpr (kDirect) {
        const T* bt = Bm + t * p.B_sl;
        const T* ct = Cm + t * p.C_sl;
#pragma unroll
        for (int n = 0; n < kMaxN; ++n) {
          if (n < dstate) {
            x[n] = exp2f(dtl * a[n]) * x[n] + dtu * aum::to_float(__ldg(bt + n));
            y += aum::to_float(__ldg(ct + n)) * x[n];
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < kMaxN; ++n) {
          if (n < dstate) {
            x[n] = exp2f(dtl * a[n]) * x[n] + dtu * s_B[i][n];
            y += s_C[i][n] * x[n];
          }
        }
      }
      out[static_cast<long long>(t) * dim] =
          aum::from_float<T>((y + dskip * uv) * aum::silu(zv));
    }
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
__global__ void __launch_bounds__(kThreads)
scan_dual_fwd_kernel(const ScanDir fwd, const ScanDir rev, int seqlen, int dim, int dstate) {
  __shared__ float s_B[kChunk][kMaxN];
  __shared__ float s_C[kChunk][kMaxN];
  const bool reverse = blockIdx.z == 1;
  scan_chain<T, kSave, false, false>(reverse ? rev : fwd, reverse, seqlen, dim, dstate, s_B,
                                     s_C);
}

// The same, reading B/C per step from global memory.
template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads)
scan_dual_direct_fwd_kernel(const ScanDir fwd, const ScanDir rev, int seqlen, int dim,
                            int dstate) {
  const bool reverse = blockIdx.z == 1;
  scan_chain<T, kSave, false, true>(reverse ? rev : fwd, reverse, seqlen, dim, dstate,
                                    nullptr, nullptr);
}

// One direction, reversed or not at run time.
template <typename T, bool kSave, bool kState>
__global__ void __launch_bounds__(kThreads)
scan_single_fwd_kernel(const ScanDir p, int reverse, int seqlen, int dim, int dstate) {
  __shared__ float s_B[kChunk][kMaxN];
  __shared__ float s_C[kChunk][kMaxN];
  scan_chain<T, kSave, kState, false>(p, reverse != 0, seqlen, dim, dstate, s_B, s_C);
}

template <typename T>
void launch_dual(const ScanDir& fwd, const ScanDir& rev, bool direct, int batch, int seqlen,
                 int dim, int dstate, cudaStream_t s) {
  const dim3 grid((dim + kThreads - 1) / kThreads, batch, 2);
  const bool save = fwd.xb != nullptr;
  if (direct && save) {
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
  const dim3 grid((dim + kThreads - 1) / kThreads, batch, 1);
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

int dual_fwd(const ScanDir* fwd, const ScanDir* rev, bool direct, int batch, int seqlen,
             int dim, int dstate, int dtype, void* stream) {
  if (bad_sizes(batch, seqlen, dim, dstate) ||
      (fwd->xb == nullptr) != (rev->xb == nullptr) || fwd->x0 != nullptr ||
      fwd->xfin != nullptr || rev->x0 != nullptr || rev->xfin != nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_dual<float>(*fwd, *rev, direct, batch, seqlen, dim, dstate, s);
  } else if (dtype == 1) {
    launch_dual<__nv_bfloat16>(*fwd, *rev, direct, batch, seqlen, dim, dstate, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The chunk length of the saved states (xb's second axis is ceil(L / it)).
int aum_scan_state_chunk() { return kChunk; }

// dtype: 0 = fp32 streams, 1 = bf16 streams. Both directions save states
// (xb set in both) or neither does; neither carries a state in or out.
// Returns cudaGetLastError() after the launch (0 on success); a refused
// launch never runs.
int aum_selective_scan_dual_fwd(const ScanDir* fwd, const ScanDir* rev,
                                int batch, int seqlen, int dim, int dstate,
                                int dtype, void* stream) {
  return dual_fwd(fwd, rev, false, batch, seqlen, dim, dstate, dtype, stream);
}

// The same function through the direct kernel (no staging of B/C).
int aum_selective_scan_dual_direct_fwd(const ScanDir* fwd, const ScanDir* rev,
                                       int batch, int seqlen, int dim, int dstate,
                                       int dtype, void* stream) {
  return dual_fwd(fwd, rev, true, batch, seqlen, dim, dstate, dtype, stream);
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
