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
// of N. All three kernels run one walk, scan_walk, so they cannot drift
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
// in flight.

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
constexpr int kSub = 8;  // steps whose streams are loaded together, one sub-chunk ahead
// Blocks per SM the registers are capped for, each measured best on an
// H100: 4 (128 registers, a few bytes of spills) for the dual eval forward
// and the direct one, 3 (168) for the saving dual forward and the
// single-direction forward.
constexpr int kMinBlocks = 3;
constexpr int kMinBlocksWide = 4;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kChunk % kSub == 0, "chunks start on a sub-chunk");
static_assert(kMaxN * kChunk % kThreads == 0, "the staging loop has no remainder");

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
// no barriers).
template <typename T, bool kSave, bool kState, bool kDirect>
__device__ __forceinline__ void scan_walk(const ScanDir& p, bool reverse, int seqlen,
                                          int dim, int dstate, float (*s_B)[kMaxN],
                                          float (*s_C)[kMaxN]) {
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

  // a[n] = A[d, n] log2 e, so that the decay is one multiply and one exp2.
  // States n >= dstate keep a = 0, B = 0 and x = 0: they stay zero.
  float a[kMaxN], x[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    const bool has_n = active && n < dstate;
    a[n] = has_n ? p.A[static_cast<long long>(d) * dstate + n] * kLog2e : 0.0f;
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
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const bool in = i0 + j < seqlen;  // past the end: zeros, unused
      s.dt[j] = in ? aum::to_float(pd[j * dt_step]) : 0.0f;
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
        const float dtv = cur.dt[j];
        const float dtu = dtv * cur.u[j];
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

template <typename T>
void launch_dual(const ScanDir& fwd, const ScanDir& rev, bool direct, int batch, int seqlen,
                 int dim, int dstate, cudaStream_t s) {
  const dim3 grid = grid_of(batch, dim, 2);
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
