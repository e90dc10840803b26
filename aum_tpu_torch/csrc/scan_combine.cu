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
//              dD  += gy u,  dbias += ddelta     (fp32, one partial per batch row)
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
// neighbouring threads on neighbouring channels. The backward's dD and
// dbias reduce over t: one thread per (b, d) walks the sequence (grid =
// (ceil(D / kThreads), batch, directions)), coalesced over d at every step,
// and writes one partial per batch row, summed by the wrapper as the scan
// kernels' are. The first design, simple and right; making it fast is later
// work.

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
  float* dD_part;         // (B, D)
  float* dbias_part;      // (B, D)
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_bwd_kernel(const CombineBwdArgs args, int nslices, int batch, int seqlen, int dim) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= dim) return;
  const int b = blockIdx.y;
  const CombineBwdDir& p = args.dir[blockIdx.z];
  const long long plane = static_cast<long long>(batch) * seqlen * dim;
  const float dskip = p.Dskip[d];
  const T* g = static_cast<const T*>(p.g) + b * p.g_sb + d;
  const T* z = static_cast<const T*>(p.z) + b * p.z_sb + d;
  const T* u = static_cast<const T*>(p.u) + b * p.u_sb + d;
  float dD = 0.0f, dbias = 0.0f;
  for (int t = 0; t < seqlen; ++t) {
    const long long e = (static_cast<long long>(b) * seqlen + t) * dim + d;
    const float gv = aum::to_float(g[t * p.g_sl]);
    const float uv = aum::to_float(u[t * p.u_sl]);
    float gy = gv;
    if (p.z != nullptr) {
      float y = 0.0f;
      for (int s = 0; s < nslices; ++s) y += p.y_parts[s * plane + e];
      y = fmaf(dskip, uv, y);
      const float zv = aum::to_float(z[t * p.z_sl]);
      const float sig = aum::sigmoid_fast(zv);
      gy = gv * zv * sig;
      static_cast<T*>(p.dz)[e] = aum::from_float<T>(gv * y * (sig * (1.0f + zv * (1.0f - sig))));
    }
    float du = 0.0f, dd = 0.0f;
    for (int s = 0; s < nslices; ++s) {
      du += p.du_parts[s * plane + e];
      dd += p.dd_parts[s * plane + e];
    }
    dD = fmaf(gy, uv, dD);
    dbias += dd;
    static_cast<T*>(p.du)[e] = aum::from_float<T>(fmaf(gy, dskip, du));
    static_cast<T*>(p.ddelta)[e] = aum::from_float<T>(dd);
  }
  p.dD_part[static_cast<long long>(b) * dim + d] = dD;
  p.dbias_part[static_cast<long long>(b) * dim + d] = dbias;
}

bool bad_sizes(int ndir, int nslices, int batch, int seqlen, int dim) {
  return ndir < 1 || ndir > 2 || nslices < 1 || batch < 1 || seqlen < 1 || dim < 1 ||
         batch * ndir > 65535 ||
         static_cast<long long>((dim + kThreads - 1) / kThreads) * seqlen > 2147483647LL;
}

}  // namespace

extern "C" {

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
  AUM_KERNEL(combine_bwd_kernel<__nv_bfloat16>)
  AUM_KERNEL(combine_bwd_kernel<float>)
#undef AUM_KERNEL
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
  const dim3 grid((dim + kThreads - 1) / kThreads, batch, ndir);
  if (dtype == 0) {
    combine_bwd_kernel<float><<<grid, kThreads, 0, s>>>(*args, nslices, batch, seqlen, dim);
  } else if (dtype == 1) {
    combine_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(*args, nslices, batch, seqlen,
                                                                dim);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

AUM_DEFINE_ERROR_STRING(aum_scan_combine_error_string)
