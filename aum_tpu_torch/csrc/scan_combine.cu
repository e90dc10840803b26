// Combine of a sliced selective scan, forward and backward (sm_90a).
//
// Part of the counterpart of the TPU scan kernels at state sizes above 16
// (aum_tpu/ops/selective_scan.py: _prep pads N to a multiple of 8, and
// _fwd_kernel_dual / _fwd_kernel_z sum y over the padded states in fp32 and
// cast once) and of the scan without z or D. The scan kernels run such a
// scan as S slices of 16 states (selective_scan.cu, built ungated), each
// writing the fp32 partial y_s = sum_{n in slice s} C_t[n] x_t[n]; per
// direction, per (b, t, d):
//
//   forward:   y    = sum_s y_s + D u            (fp32, the slices in order)
//              out  = y silu(z)  (y without z)   (cast once to u's dtype)
//   backward:  y    = sum_s y_s + D u            (the slices' recomputed y_s)
//              gy   = g silu(z)  (g without z)
//              du   = sum_s du_s + D gy          (the slices' fp32 partials)
//              ddelta = sum_s ddelta_s           (fp32, through the softplus)
//              dz   = g y sigmoid(z) (1 + z (1 - sigmoid(z)))
//              dD  += gy u,  dbias += ddelta     (fp32, one partial per (b, chunk))
//
// The backward's slices (selective_scan_bwd.cu and selective_scan_bwd_fused.cu,
// ungated) form gy themselves and write the du and ddelta partials and, with
// z, their y_s as they recompute it (so the forward saves no pre-gate y);
// dz needs the whole pre-gate y and dD the whole gy, so both are formed
// here, never from one slice. The gate is the scan kernels' SFU SiLU.
//
// What bounds it: bytes. Per element the forward reads S fp32 partials, u
// and z and writes out, with S + 4 operations; the backward reads 3 S
// partials (2 S without z), g, z and u and writes du, ddelta and dz. Both
// are far below the card's ratio of operations to bytes.
//
// Design: the forward is elementwise, one thread per (t, d) of a batch row
// and direction (grid = (ceil(D / kThreads) x L, batch x directions), so
// that L has the 2^31 - 1 blocks of grid.x and no cap of its own),
// neighbouring threads on neighbouring channels. The backward is elementwise
// too but for dD and dbias, which reduce over (b, t). Its first design, one
// thread per (b, d) walking all L steps (288 blocks at the train shapes, 9
// warps per SM), took 5.4x its bytes bound on an H100: each step's 3 S + 3
// loads, issued one step at a time, wait out the memory's latency with too
// few warps to cover it. Now a thread owns kBwdVec = 4 neighbouring
// channels over a chunk of kBwdChunk = 32 steps (grid = (ceil(D / (4
// kBwdThreads)) x ceil(L / 32), batch x directions): 1224 blocks of 4
// warps at the train shapes, 7 blocks an SM at 66 registers) and reads
// every plane and stream as one vector of the 4 channels (16 bytes of fp32,
// 8 of bf16). Issuing two steps' loads before their stores was measured
// slower on an H100 (116 registers, 4 blocks an SM), as was capping the
// registers at 64 (spills). Each (b, chunk) writes its own dD and dbias
// partials per channel, which the wrapper sums over (b, chunk) in a fixed
// order: no atomics, so the result is the same bits from run to run. Where
// D is not a multiple of 4 or a stream breaks the vectors' alignment, the
// same kernel moves the 4 channels value by value.

#include <cstdint>

#include "common.cuh"

// One direction. (B, L, D) streams have channel stride 1; parts are
// (S, B, L, D) fp32, contiguous.
struct CombineDir {
  const float* parts;  // the slices' y partials
  const void* u;
  const void* z;       // or null: no gate
  const float* Dskip;  // (D,) fp32
  void* out;           // (B, L, D), contiguous, u's dtype
  long long u_sb, u_sl, z_sb, z_sl;
};

struct CombineBwdDir {
  const float* du_parts;  // (S, B, L, D) fp32
  const float* dd_parts;  // (S, B, L, D) fp32
  const float* y_parts;   // (S, B, L, D) fp32, or null without z
  const void* g;
  const void* z;          // or null: no gate, no dz
  const void* u;
  const float* Dskip;     // (D,) fp32
  void* du;               // (B, L, D), contiguous, stream dtype
  void* ddelta;           // (B, L, D), contiguous, stream dtype
  void* dz;               // (B, L, D), contiguous, stream dtype, or null without z
  float* dD_part;         // (B, ceil(L / kBwdChunk), D): one row per (b, chunk)
  float* dbias_part;      // (B, ceil(L / kBwdChunk), D)
  long long g_sb, g_sl, z_sb, z_sl, u_sb, u_sl;
};

struct CombineArgs {
  CombineDir dir[2];
};
struct CombineBwdArgs {
  CombineBwdDir dir[2];
};

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_fwd_kernel(const CombineArgs args, int nslices, int batch, int seqlen, int dim) {
  const int dblocks = (dim + kThreads - 1) / kThreads;
  const int t = blockIdx.x / dblocks;
  const int d = (blockIdx.x % dblocks) * kThreads + threadIdx.x;
  if (d >= dim) return;
  const int b = blockIdx.y % batch;
  const CombineDir& p = args.dir[blockIdx.y / batch];
  const long long e = (static_cast<long long>(b) * seqlen + t) * dim + d;
  const long long plane = static_cast<long long>(batch) * seqlen * dim;
  float y = 0.0f;
  for (int s = 0; s < nslices; ++s) y += p.parts[s * plane + e];
  const float u = aum::to_float(static_cast<const T*>(p.u)[b * p.u_sb + t * p.u_sl + d]);
  y = fmaf(p.Dskip[d], u, y);
  if (p.z != nullptr) {
    y *= aum::silu_fast(aum::to_float(static_cast<const T*>(p.z)[b * p.z_sb + t * p.z_sl + d]));
  }
  static_cast<T*>(p.out)[e] = aum::from_float<T>(y);
}

// The backward's layout: threads per block, channels per thread and steps
// per block (one dD / dbias partial row each).
constexpr int kBwdThreads = 128;
constexpr int kBwdVec = 4;
constexpr int kBwdChunk = 32;

// kBwdVec neighbouring channels as fp32: one vector (16 bytes of fp32, 8 of
// bf16) where kVector (aligned; the host checked), else value by value
// (zeros past the nc channels left).
template <bool kVector>
__device__ __forceinline__ void load4(const float* p, float (&v)[kBwdVec], int nc) {
  if (kVector) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
  } else {
#pragma unroll
    for (int c = 0; c < kBwdVec; ++c) v[c] = c < nc ? __ldg(p + c) : 0.0f;
  }
}

template <bool kVector>
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[kBwdVec], int nc) {
  if (kVector) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(r.x << 16), v[1] = __uint_as_float(r.x & 0xffff0000u);
    v[2] = __uint_as_float(r.y << 16), v[3] = __uint_as_float(r.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int c = 0; c < kBwdVec; ++c) v[c] = c < nc ? __bfloat162float(__ldg(p + c)) : 0.0f;
  }
}

template <bool kVector>
__device__ __forceinline__ void store4(float* p, const float (&v)[kBwdVec], int nc) {
  if (kVector) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < kBwdVec; ++c) {
      if (c < nc) p[c] = v[c];
    }
  }
}

template <bool kVector>
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[kBwdVec], int nc) {
  if (kVector) {
    unsigned w[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      w[k] = __bfloat16_as_ushort(__float2bfloat16(v[2 * k])) |
             (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(v[2 * k + 1]))) << 16);
    }
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int c = 0; c < kBwdVec; ++c) {
      if (c < nc) p[c] = __float2bfloat16(v[c]);
    }
  }
}

template <typename T, bool kVector>
__global__ void __launch_bounds__(kBwdThreads)
combine_bwd_kernel(const CombineBwdArgs args, int nslices, int batch, int seqlen, int dim) {
  const int dblocks = (dim + kBwdThreads * kBwdVec - 1) / (kBwdThreads * kBwdVec);
  const int chunk = blockIdx.x / dblocks;
  const int c0 = ((blockIdx.x % dblocks) * kBwdThreads + threadIdx.x) * kBwdVec;
  if (c0 >= dim) return;
  const int nc = min(kBwdVec, dim - c0);
  const int b = blockIdx.y % batch;
  const CombineBwdDir& p = args.dir[blockIdx.y / batch];
  const bool gated = p.z != nullptr;
  const long long plane = static_cast<long long>(batch) * seqlen * dim;
  const int t0 = chunk * kBwdChunk;
  const int n = min(kBwdChunk, seqlen - t0);  // steps of this chunk
  float dskip[kBwdVec];
  load4<kVector>(p.Dskip + c0, dskip, nc);
  const T* g = static_cast<const T*>(p.g) + b * p.g_sb + c0;
  const T* z = static_cast<const T*>(p.z) + b * p.z_sb + c0;
  const T* u = static_cast<const T*>(p.u) + b * p.u_sb + c0;
  float dD[kBwdVec] = {}, dbias[kBwdVec] = {};
  for (int t = t0; t < t0 + n; ++t) {
    // Every load of the step first: the slices' planes summed in slice
    // order, then the streams.
    const long long e = (static_cast<long long>(b) * seqlen + t) * dim + c0;
    float du[kBwdVec] = {}, dd[kBwdVec] = {}, y[kBwdVec] = {};
    for (int s = 0; s < nslices; ++s) {
      float a[kBwdVec], c[kBwdVec], v[kBwdVec];
      load4<kVector>(p.du_parts + s * plane + e, a, nc);
      load4<kVector>(p.dd_parts + s * plane + e, c, nc);
      if (gated) load4<kVector>(p.y_parts + s * plane + e, v, nc);
#pragma unroll
      for (int i = 0; i < kBwdVec; ++i) {
        du[i] += a[i];
        dd[i] += c[i];
        if (gated) y[i] += v[i];
      }
    }
    float gv[kBwdVec], uv[kBwdVec], zv[kBwdVec];
    load4<kVector>(g + t * p.g_sl, gv, nc);
    load4<kVector>(u + t * p.u_sl, uv, nc);
    if (gated) load4<kVector>(z + t * p.z_sl, zv, nc);
    float o_du[kBwdVec], o_dz[kBwdVec];
#pragma unroll
    for (int i = 0; i < kBwdVec; ++i) {
      float gy = gv[i];
      if (gated) {
        const float yv = fmaf(dskip[i], uv[i], y[i]);
        const float sig = aum::sigmoid_fast(zv[i]);
        gy = gv[i] * zv[i] * sig;
        o_dz[i] = gv[i] * yv * (sig * (1.0f + zv[i] * (1.0f - sig)));
      }
      dD[i] = fmaf(gy, uv[i], dD[i]);
      dbias[i] += dd[i];
      o_du[i] = fmaf(gy, dskip[i], du[i]);
    }
    store4<kVector>(static_cast<T*>(p.du) + e, o_du, nc);
    store4<kVector>(static_cast<T*>(p.ddelta) + e, dd, nc);
    if (gated) store4<kVector>(static_cast<T*>(p.dz) + e, o_dz, nc);
  }
  const int nchunks = gridDim.x / dblocks;
  const long long row = (static_cast<long long>(b) * nchunks + chunk) * dim + c0;
  store4<kVector>(p.dD_part + row, dD, nc);
  store4<kVector>(p.dbias_part + row, dbias, nc);
}

// Whether every plane, stream and partial of the backward's directions
// takes kBwdVec-channel vectors: D a multiple of 4, bases and strides
// aligned to a vector.
template <typename T>
bool bwd_vectors(const CombineBwdArgs& a, int ndir, int dim) {
  constexpr long long kAlign = kBwdVec * sizeof(T);
  auto ok = [&](const void* ptr) {
    return ptr == nullptr || reinterpret_cast<unsigned long long>(ptr) % kAlign == 0;
  };
  auto ok32 = [&](const void* ptr) {
    return ptr == nullptr || reinterpret_cast<unsigned long long>(ptr) % 16 == 0;
  };
  if (dim % kBwdVec != 0) return false;
  for (int i = 0; i < ndir; ++i) {
    const CombineBwdDir& p = a.dir[i];
    if (!ok32(p.du_parts) || !ok32(p.dd_parts) || !ok32(p.y_parts) || !ok32(p.Dskip) ||
        !ok32(p.dD_part) || !ok32(p.dbias_part) || !ok(p.g) || !ok(p.z) || !ok(p.u) ||
        !ok(p.du) || !ok(p.ddelta) || !ok(p.dz)) {
      return false;
    }
    const long long strides[] = {p.g_sb, p.g_sl, p.z_sb, p.z_sl, p.u_sb, p.u_sl};
    for (long long stride : strides) {
      if (stride % kBwdVec != 0) return false;
    }
  }
  return true;
}

template <typename T>
void launch_bwd(const CombineBwdArgs& a, int ndir, int nslices, int batch, int seqlen, int dim,
                cudaStream_t s) {
  const int dblocks = (dim + kBwdThreads * kBwdVec - 1) / (kBwdThreads * kBwdVec);
  const dim3 grid(dblocks * ((seqlen + kBwdChunk - 1) / kBwdChunk), batch * ndir);
  if (bwd_vectors<T>(a, ndir, dim)) {
    combine_bwd_kernel<T, true><<<grid, kBwdThreads, 0, s>>>(a, nslices, batch, seqlen, dim);
  } else {
    combine_bwd_kernel<T, false><<<grid, kBwdThreads, 0, s>>>(a, nslices, batch, seqlen, dim);
  }
}

bool bad_sizes(int ndir, int nslices, int batch, int seqlen, int dim) {
  return ndir < 1 || ndir > 2 || nslices < 1 || batch < 1 || seqlen < 1 || dim < 1 ||
         batch * ndir > 65535 ||
         static_cast<long long>((dim + kThreads - 1) / kThreads) * seqlen > 2147483647LL;
}

}  // namespace

extern "C" {

// The backward's steps per (b, chunk) partial of dD and dbias: the wrapper
// sizes its (batch x ceil(L / it), D) partial buffers by it.
int aum_scan_combine_bwd_chunk() { return kBwdChunk; }

// The resources of the i-th kernel instantiation (aum_kernel_resources in
// common.cuh: info[0..5]) and its name; 0 on success, a CUDA error, or -1
// past the last one.
int aum_kernel_info(int i, int* info, const char** name) {
  int n = 0;
#define AUM_KERNEL(...)                                             \
  if (i == n++) {                                                   \
    *name = #__VA_ARGS__;                                           \
    return aum_kernel_resources(__VA_ARGS__, kThreads, 0, info);    \
  }
  AUM_KERNEL(combine_fwd_kernel<__nv_bfloat16>)
  AUM_KERNEL(combine_fwd_kernel<float>)
#undef AUM_KERNEL
#define AUM_BWD_KERNEL(...)                                         \
  if (i == n++) {                                                   \
    *name = #__VA_ARGS__;                                           \
    return aum_kernel_resources(__VA_ARGS__, kBwdThreads, 0, info); \
  }
  AUM_BWD_KERNEL(combine_bwd_kernel<__nv_bfloat16, true>)
  AUM_BWD_KERNEL(combine_bwd_kernel<float, true>)
  AUM_BWD_KERNEL(combine_bwd_kernel<__nv_bfloat16, false>)
#undef AUM_BWD_KERNEL
  return -1;
}

// ndir directions (1 or 2) from args->dir, nslices partial planes each;
// dtype: 0 = fp32 streams, 1 = bf16. Returns cudaGetLastError() after the
// launch (0 on success); a refused launch never runs.
int aum_scan_combine_fwd(const CombineArgs* args, int ndir, int nslices, int batch,
                         int seqlen, int dim, int dtype, void* stream) {
  if (bad_sizes(ndir, nslices, batch, seqlen, dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((dim + kThreads - 1) / kThreads * seqlen, batch * ndir);
  if (dtype == 0) {
    combine_fwd_kernel<float><<<grid, kThreads, 0, s>>>(*args, nslices, batch, seqlen, dim);
  } else if (dtype == 1) {
    combine_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(*args, nslices, batch, seqlen,
                                                                dim);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same for the backward: z, y_parts and dz all set or all null per direction.
int aum_scan_combine_bwd(const CombineBwdArgs* args, int ndir, int nslices, int batch,
                         int seqlen, int dim, int dtype, void* stream) {
  if (bad_sizes(ndir, nslices, batch, seqlen, dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < ndir; ++i) {
    const CombineBwdDir& p = args->dir[i];
    if ((p.z == nullptr) != (p.y_parts == nullptr) || (p.z == nullptr) != (p.dz == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_bwd<float>(*args, ndir, nslices, batch, seqlen, dim, s);
  } else if (dtype == 1) {
    launch_bwd<__nv_bfloat16>(*args, ndir, nslices, batch, seqlen, dim, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

AUM_DEFINE_ERROR_STRING(aum_scan_combine_error_string)
