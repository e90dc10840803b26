// Selective-scan backward with a one-level recompute, one or both directions
// in one launch (sm_90a).
//
// Replaces the TPU kernel aum_tpu/ops/selective_scan.py:_bwd_kernel_fused
// (the opt-in behind AUM_SCAN_BWD_FUSED=1): the same function and outputs as
// selective_scan_bwd.cu (K2) without its with_state form, so its plain
// version is K2's, selective_scan_bwd_plain; see K2's source for the math.
// Like the TPU kernel it has no x-minus form (its dla is always lam a x_{t-1})
// and writes bf16 dB/dC partials under AUM_SCAN_BWD_BF16_PARTIALS=1
// (kBf16Part), rounded per block of 16 channels where the TPU kernel rounds
// per d-tile.
// The TPU kernel's idea carried over: each chunk of kChunk steps is
// recomputed once from its saved entry state, the state before every step
// of the chunk is kept in fast memory, and the adjoint walks back over those
// states forming every grad per step. K2 recomputes on two levels instead
// (sub-chunk entry states, then per-step states), so it evaluates each a_t
// three times; this kernel twice (the recompute walk and the adjoint).
//
// Design: K2's lane layout (a chain (batch, channel, direction) over 4 lanes
// of 4 states; 8 channels per warp) and its adjoint step (adjoint_step in
// scan_bwd.cuh). The price is shared memory: a chunk of pre-step states is
// 64 x 16 fp32 = 4 KB per chain, against K2's ~1.4 KB. A block is kWarps = 2
// warps (16 channels, grid = (ceil(D / 16), batch, directions)) holding 64
// KB of states, B_t/C_t of the chunk (8 KB) and its warps' dB/dC rows: 74 KB
// of dynamic shared memory, so 3 blocks (6 warps) per SM, against K2's 20
// warps. That is the trade the TPU kernel made with VMEM. The recompute walk
// loads dt and u per kSub steps together; the adjoint loads dt, u, z and g
// per kSub steps and, every kSub steps, the block writes its dB/dC rows:
// fp32 partials (ceil(D / 16), batch, L, 32), summed by the wrapper (no
// atomics), as K2's (ceil(D / 32), ...). dA, dD and dbias are register
// accumulators, one partial per batch row as in K2.
//
// What bounds it: the same function as K2, so the same bound (one exp2 and
// about a dozen FP32-pipe instructions per (b, l, d, n) element and
// direction: operations, not bytes). It does one exp2 fewer per element than
// K2, with fewer warps to hide each step's dependent chain.

#include <cstdint>
#include <type_traits>

#include "scan_bwd.cuh"

namespace {

using namespace aum::bwd;

constexpr int kWarps = 2;                              // warps per block
constexpr int kThreads = kWarp * kWarps;               // 64
constexpr int kChanPerBlock = kChanPerWarp * kWarps;  // 16, one partial row

struct Smem {
  float x[kChunk][kNL][kThreads];  // the state before each step of the chunk
  float B[kChunk][kMaxN];
  float C[kChunk][kMaxN];
  float dbc[kSub][kWarps][kRow];   // each warp's dB/dC sums per step
};

// kSoftplus: dt came through the softplus; kBf16Part: bf16 dB/dC partials.
template <typename T, bool kSoftplus, bool kBf16Part = false>
__global__ void __launch_bounds__(kThreads, 3)
scan_bwd_fused_kernel(const ScanBwdArgs args, int batch, int seqlen, int dim, int dstate) {
  using Part = std::conditional_t<kBf16Part, __nv_bfloat16, float>;
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

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
  const T* z = static_cast<const T*>(p.z) + b * p.z_sb + dc;
  const T* g = static_cast<const T*>(p.g) + b * p.g_sb + dc;
  const T* Bm = static_cast<const T*>(p.B) + b * p.B_sb;
  const T* Cm = static_cast<const T*>(p.C) + b * p.C_sb;
  const long long row = static_cast<long long>(b) * seqlen * dim + dc;
  T* du = static_cast<T*>(p.du) + row;
  T* ddelta = static_cast<T*>(p.ddelta) + row;
  T* dz = static_cast<T*>(p.dz) + row;
  Part* dbc = static_cast<Part*>(p.dbc_part) +
              (static_cast<long long>(blockIdx.x) * batch + b) * seqlen * kRow;
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
    __syncthreads();  // every thread is done with the previous chunk's B/C
    // Staged with zeros beyond dstate, so every lane reads kNL values.
    for (int idx = tid; idx < len * kMaxN; idx += kThreads) {
      const int i = idx / kMaxN;
      const int n = idx - i * kMaxN;
      const int t = reverse ? seqlen - 1 - (c0 + i) : c0 + i;
      sm.B[i][n] = n < dstate ? aum::to_float(Bm[t * p.B_sl + n]) : 0.0f;
      sm.C[i][n] = n < dstate ? aum::to_float(Cm[t * p.C_sl + n]) : 0.0f;
    }
    __syncthreads();

    // The recompute: walk the chunk once from its saved entry state, keeping
    // the state before every step (each thread reads back only its own).
    float x[kNL];
    const float* xb = p.xb + ((static_cast<long long>(b) * n_chunks + c) * dstate + n0) * dim + dc;
#pragma unroll
    for (int k = 0; k < kNL; ++k) x[k] = has_n[k] ? xb[static_cast<long long>(k) * dim] : 0.0f;
    for (int i0 = 0; i0 < len; i0 += kSub) {
      float dtr[kSub], ur[kSub];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const bool in = active && i0 + j < len;
        const int i = i0 + j;
        const int t = reverse ? seqlen - 1 - (c0 + i) : c0 + i;
        dtr[j] = load(dt, t * p.dt_sl, in);
        ur[j] = load(u, t * p.u_sl, in);
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        if (i0 + j < len) {
#pragma unroll
          for (int k = 0; k < kNL; ++k) sm.x[i0 + j][k][tid] = x[k];
          advance(x, A, &sm.B[i0 + j][n0], dtr[j], ur[j]);
        }
      }
    }

    // The adjoint, against the scan's direction, kSub steps at a time.
    for (int i0 = (len - 1) / kSub * kSub; i0 >= 0; i0 -= kSub) {
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
      OwnSteps own;
#pragma unroll
      for (int j = kSub - 1; j >= 0; --j) {
        if (j >= slen) continue;
        const int i = i0 + j;
        sm.dbc[j][warp][row_pos] = adjoint_step(
            j, &sm.x[i][0][tid], kThreads, &sm.B[i][n0], &sm.C[i][n0], A, lam, dA, dD, own,
            dtr[j], ur[j], zr[j], gr[j], dskip, lane);
      }
      // The lane's own steps' streams, read again (they are in L1).
      auto streams = [&](int j, float& dtv, float& uv, float& zv, float& gv) {
        const int t = reverse ? seqlen - 1 - (c0 + i0 + j) : c0 + i0 + j;
        dtv = aum::to_float(dt[t * p.dt_sl]);
        uv = aum::to_float(u[t * p.u_sl]);
        zv = aum::to_float(z[t * p.z_sl]);
        gv = aum::to_float(g[t * p.g_sl]);
      };
      write_own<T, kSoftplus>(own, streams, du, ddelta, dz, c0 + i0, slen, seqlen, reverse,
                              dim, dskip, active, q, dbias);
      // The block's dB/dC row of each step: the sum of its warps' rows.
      __syncthreads();
      for (int idx = tid; idx < slen * kRow; idx += kThreads) {
        const int j = idx / kRow;
        const int r = idx - j * kRow;
        const int t = reverse ? seqlen - 1 - (c0 + i0 + j) : c0 + i0 + j;
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += sm.dbc[j][w][r];
        dbc[static_cast<long long>(t) * kRow + r] = aum::from_float<Part>(sum);
      }
      __syncthreads();  // sm.dbc is free for the next kSub steps
    }
  }

  dbias = group_sum(dbias);  // each lane summed the steps it wrote
#pragma unroll
  for (int k = 0; k < kNL; ++k) {
    if (has_n[k]) p.dA_part[(static_cast<long long>(b) * dstate + n0 + k) * dim + d] = dA[k];
  }
  if (active && q == 0) {
    p.dD_part[static_cast<long long>(b) * dim + d] = dD;
    p.dbias_part[static_cast<long long>(b) * dim + d] = dbias;
  }
}

template <typename T, bool kSoftplus, bool kBf16Part>
int launch_form(const ScanBwdArgs& args, int ndir, int batch, int seqlen, int dim, int dstate,
                cudaStream_t s) {
  // Above 48 KB a block's shared memory must be asked for (per device, so
  // at every launch: the call is cheap).
  const auto kernel = scan_bwd_fused_kernel<T, kSoftplus, kBf16Part>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((dim + kChanPerBlock - 1) / kChanPerBlock, batch, ndir);
  kernel<<<grid, kThreads, sizeof(Smem), s>>>(args, batch, seqlen, dim, dstate);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const ScanBwdArgs& args, int ndir, int batch, int seqlen, int dim, int dstate,
           cudaStream_t s) {
  const bool part = args.dir[0].bf16_partials != 0;
  if (args.dir[0].softplus != 0) {
    return part ? launch_form<T, true, true>(args, ndir, batch, seqlen, dim, dstate, s)
                : launch_form<T, true, false>(args, ndir, batch, seqlen, dim, dstate, s);
  }
  return part ? launch_form<T, false, true>(args, ndir, batch, seqlen, dim, dstate, s)
              : launch_form<T, false, false>(args, ndir, batch, seqlen, dim, dstate, s);
}

}  // namespace

extern "C" {

// The chunk length of the entry states this kernel restarts from, and the
// channels of one dB/dC partial row (dbc_part's first axis is ceil(D / it)).
int aum_scan_bwd_fused_state_chunk() { return kChunk; }
int aum_scan_bwd_fused_block_channels() { return kChanPerBlock; }

// The resources of the i-th kernel instantiation this library launches
// (aum_kernel_resources in common.cuh: info[0..5], at its dynamic shared
// memory) and its name; 0 on success, a CUDA error, or -1 past the last one.
int aum_kernel_info(int i, int* info, const char** name) {
  int n = 0;
#define AUM_KERNEL(...)                                                          \
  if (i == n++) {                                                                \
    *name = #__VA_ARGS__;                                                        \
    const cudaError_t err = cudaFuncSetAttribute(                                \
        __VA_ARGS__, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem)); \
    if (err != cudaSuccess) return static_cast<int>(err);                        \
    return aum_kernel_resources(__VA_ARGS__, kThreads, sizeof(Smem), info);      \
  }
  AUM_KERNEL(scan_bwd_fused_kernel<__nv_bfloat16, true>)
  AUM_KERNEL(scan_bwd_fused_kernel<__nv_bfloat16, false>)
  AUM_KERNEL(scan_bwd_fused_kernel<float, true>)
  AUM_KERNEL(scan_bwd_fused_kernel<float, false>)
  AUM_KERNEL(scan_bwd_fused_kernel<__nv_bfloat16, true, true>)
  AUM_KERNEL(scan_bwd_fused_kernel<float, true, true>)
#undef AUM_KERNEL
  return -1;
}

// ndir directions (1 or 2) from args->dir[0 .. ndir-1]; dtype: 0 = fp32
// streams, 1 = bf16 streams. No with_state form: gfin and dx0 must be null;
// no x-minus form: xminus must be 0; both directions share softplus and
// bf16_partials.
// Returns the CUDA error of the set-up or of the launch (0 on success); a
// refused launch never runs.
int aum_selective_scan_bwd_fused(const ScanBwdArgs* args, int ndir, int batch, int seqlen,
                                 int dim, int dstate, int dtype, void* stream) {
  if (ndir < 1 || ndir > 2 || dstate < 1 || dstate > kMaxN || batch < 1 || seqlen < 1 ||
      dim < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < ndir; ++i) {
    const ScanBwdDir& p = args->dir[i];
    if (p.gfin != nullptr || p.dx0 != nullptr || p.softplus != args->dir[0].softplus ||
        p.xminus != 0 || p.bf16_partials != args->dir[0].bf16_partials) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(*args, ndir, batch, seqlen, dim, dstate, s);
  if (dtype == 1) return launch<__nv_bfloat16>(*args, ndir, batch, seqlen, dim, dstate, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

AUM_DEFINE_ERROR_STRING(aum_scan_bwd_fused_error_string)
