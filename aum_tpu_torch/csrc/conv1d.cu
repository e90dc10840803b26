// Depthwise causal / anti-causal 1D convolution + bias + optional SiLU
// (sm_90a).
//
// Replaces the TPU kernel aum_tpu/ops/conv1d.py:_conv_kernel at any width
// K, as it takes any k. Weights are (D, K), with tap k
// multiplying x[t - (K-1) + k] (causal); reverse = 1 is the anti-causal form
// out[t] = sum_i x[t + i] * w[K-1-i], i.e. flip -> causal conv -> flip.
// Out-of-range inputs are zeros (the halo), K >= L included. The taps and
// the bias are read in their own dtype (fp32 or bf16, converted exactly),
// the taps summed in fp32 in the plain version's order (causal: tap 0
// first; anti-causal: tap K-1 first), then the bias is added and the SiLU
// applied in fp32, and the result is cast once: the TPU kernel's
// compute_f32 form. The SiLU is the scan kernels' gate, v times the SFU's
// reciprocal of 1 + its exp2 (a few ulp in fp32).
//
// Two forms: widths 1 to kMaxK = 8 each have their own instantiation of
// conv1d_fwd_kernel (a template on K: the mixers' 4 among them), the taps
// and the window of inputs in registers; wider convs take
// conv1d_general_kernel, where K is a run-time value (below).
//
// What bounds it: bytes. Per element it does 2K + 4 fp32 operations and one
// exponential against one read and one write, far below the card's ratio of
// operations to bytes, so the floor is one read of x plus one write of out.
// The instructions still count: an accurate SiLU (expf, and a division
// whose rare-case branch the compiler cannot interleave) took about as long
// as the rest of the kernel on an H100, which the SFU's two instructions
// do not.
//
// The bytes do not grow with K (the K-1 halo rows of a tile are read again,
// (K-1) / kTileL of a read), the operations do (2K per element).
//
// Design of the instantiated widths: a thread owns kVec = 8 neighbouring
// channels over a tile of kTileL
// steps (grid = (ceil(D / (8 kThreads)), ceil(L / kTileL), batch)). It
// slides a K-row window of its 8 channels through registers (fp32), with the
// 8 channels' taps and biases in registers too, so each input is read from
// memory once per tile (plus the K-1 halo rows). A row of 8 channels is one
// 16-byte access in bf16 (two in fp32), neighbouring threads on neighbouring
// addresses, and the tile's rows are loaded in groups of kGroup<T> (128
// bytes a thread) issued together before any of them is used, so each
// thread keeps several loads in flight; 16 warps per SM (a 128-register
// cap) cover the memory's latency without staging through shared memory.
// Above K = 4 the taps and the window (2K - 1 rows of 8 fp32 values) take
// more registers than that cap leaves, so those widths run 8 warps per SM
// with a cap of 255.
// Where x's base, its row or batch stride, or D (not a multiple of 8) breaks
// 16-byte alignment, the same kernel, in its scalar form, reads and writes
// the 8 channels value by value.
//
// Design of the general form: registers cannot hold a run-time number of
// taps, so a block of kGenThreads threads stages in shared memory, as fp32,
// the taps of its kGenChannels channels and the rows of its tile of
// kGenTileL steps with their K - 1 halo rows (grid = (ceil(D / 64),
// ceil(L / 64), batch)). A thread owns one channel over kGenSteps = 16
// consecutive steps and keeps their 16 sums in registers; for each tap it
// reads one new input row and the tap from shared memory and does 16 FMAs,
// the rows it needs next held in a ring of 16 registers (the tap loop is
// unrolled by 16, so the ring's slots are fixed registers). A block holds
// kGenTaps taps at a time: a wider conv loops over its taps in windows of
// kGenTaps, each window staging its taps and the tile's rows they reach,
// the sums carried in registers from one window to the next (in the tap
// order above). Rows are staged in 16-byte loads where x is aligned as for
// the instantiated widths, else value by value. On an H100 this ran faster
// than the same kernel with its registers capped for 5 or 6 blocks an SM,
// or with 8 steps a thread (more shared-memory loads per FMA).

#include <cstdint>

#include "common.cuh"

struct ConvArgs {
  const void* x;       // (batch, L, D), channel stride 1
  const void* weight;  // (D, K), contiguous, fp32 or bf16 (w_dtype)
  const void* bias;    // (D,) fp32 or bf16 (b_dtype), or null
  void* out;           // (batch, L, D), contiguous, x's dtype
  long long x_sb, x_sl;
  int w_dtype, b_dtype;  // 0 = fp32, 1 = bf16
};

namespace {

constexpr int kThreads = 64;
// 16 warps per SM (at most 128 registers a thread) up to K = 4, 8 above.
template <int K>
constexpr int kMinBlocks = K <= 4 ? 8 : 4;
constexpr int kVec = 8;        // channels per thread
constexpr int kTileL = 32;     // steps per tile
constexpr int kMaxK = 8;       // the widest conv with its own instantiation

// The general form (K > kMaxK): threads per block, channels per block,
// steps per thread, steps per block and taps per window.
constexpr int kGenThreads = 256;
constexpr int kGenChannels = 64;
constexpr int kGenSteps = 16;
constexpr int kGenTileL = kGenThreads / kGenChannels * kGenSteps;
constexpr int kGenTaps = 32;

// Rows loaded together: 128 bytes a thread.
template <typename T>
constexpr int kGroup = 128 / (kVec * static_cast<int>(sizeof(T)));

// One row of a thread's 8 channels as loaded (raw bits; zeros past D).
template <typename T>
struct Row;
template <>
struct Row<__nv_bfloat16> {
  uint4 v;
};
template <>
struct Row<float> {
  float4 lo, hi;
};

__device__ __forceinline__ Row<__nv_bfloat16> load_row(const __nv_bfloat16* p, int nc,
                                                       bool vector) {
  Row<__nv_bfloat16> r;
  if (vector) {
    r.v = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned lo = 2 * k < nc ? __ldg(s + 2 * k) : 0u;
      const unsigned hi = 2 * k + 1 < nc ? __ldg(s + 2 * k + 1) : 0u;
      w[k] = lo | (hi << 16);
    }
    r.v = make_uint4(w[0], w[1], w[2], w[3]);
  }
  return r;
}

__device__ __forceinline__ Row<float> load_row(const float* p, int nc, bool vector) {
  Row<float> r;
  if (vector) {
    r.lo = __ldg(reinterpret_cast<const float4*>(p));
    r.hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  } else {
    float v[kVec];
#pragma unroll
    for (int c = 0; c < kVec; ++c) v[c] = c < nc ? __ldg(p + c) : 0.0f;
    r.lo = make_float4(v[0], v[1], v[2], v[3]);
    r.hi = make_float4(v[4], v[5], v[6], v[7]);
  }
  return r;
}

__device__ __forceinline__ void unpack(const Row<__nv_bfloat16>& r, float (&v)[kVec]) {
  const unsigned w[4] = {r.v.x, r.v.y, r.v.z, r.v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // element 2k in the low half, as bf16 pairs lie
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const Row<float>& r, float (&v)[kVec]) {
  v[0] = r.lo.x, v[1] = r.lo.y, v[2] = r.lo.z, v[3] = r.lo.w;
  v[4] = r.hi.x, v[5] = r.hi.y, v[6] = r.hi.z, v[7] = r.hi.w;
}

__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float (&v)[kVec], int nc,
                                          bool vector) {
  if (vector) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned lo = __bfloat16_as_ushort(__float2bfloat16(v[2 * k]));
      const unsigned hi = __bfloat16_as_ushort(__float2bfloat16(v[2 * k + 1]));
      w[k] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      if (c < nc) p[c] = __float2bfloat16(v[c]);
    }
  }
}

__device__ __forceinline__ void store_row(float* p, const float (&v)[kVec], int nc,
                                          bool vector) {
  if (vector) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      if (c < nc) p[c] = v[c];
    }
  }
}

// Element i of a parameter in its own dtype, as fp32 (exact).
__device__ __forceinline__ float param(const void* p, int dtype, long long i) {
  return dtype == 1 ? __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(p) + i))
                    : __ldg(static_cast<const float*>(p) + i);
}

// kVector: every row of x and out is read and written as 16-byte vectors
// (the host checked the alignment); else value by value. K: the width.
template <typename T, bool kReverse, bool kVector, int K = 4>
__global__ void __launch_bounds__(kThreads, kMinBlocks<K>)
conv1d_fwd_kernel(const ConvArgs a, int seqlen, int dim, int silu) {
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (c0 >= dim) return;
  const int nc = min(kVec, dim - c0);
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kTileL;
  const int n = min(kTileL, seqlen - t0);  // steps of this tile

  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + c0;
  T* out = static_cast<T*>(a.out) + static_cast<long long>(b) * seqlen * dim + c0;

  float w[K][kVec], bias[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    const bool in = c < nc;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      w[k][c] = in ? param(a.weight, a.w_dtype, static_cast<long long>(c0 + c) * K + k) : 0.0f;
    }
    bias[c] = in && a.bias != nullptr ? param(a.bias, a.b_dtype, c0 + c) : 0.0f;
  }

  // Processed step p of the tile is step t0 + p (causal) or t0 + n - 1 - p
  // (anti-causal: the tile walked backwards); win[i] holds processed step
  // p - (K-1) + i before step p, zeros outside the sequence.
  auto step_of = [&](int p) { return kReverse ? t0 + n - 1 - p : t0 + p; };
  float win[K > 1 ? K - 1 : 1][kVec];
#pragma unroll
  for (int i = 0; i < K - 1; ++i) {
    const int t = step_of(i - (K - 1));
    Row<T> r = {};
    if (t >= 0 && t < seqlen) r = load_row(x + t * a.x_sl, nc, kVector);
    unpack(r, win[i]);
  }

  constexpr int G = kGroup<T>;
  for (int g0 = 0; g0 < n; g0 += G) {
    Row<T> rows[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {  // every load of the group first
      rows[j] = {};
      if (g0 + j < n) rows[j] = load_row(x + step_of(g0 + j) * a.x_sl, nc, kVector);
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (g0 + j < n) {
        float cur[kVec], y[kVec];
        unpack(rows[j], cur);
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          // Tap k multiplies the window's row k (cur is row K-1).
          float acc;
          if (kReverse) {
            acc = cur[c] * w[K - 1][c];
#pragma unroll
            for (int k = K - 2; k >= 0; --k) acc += win[k][c] * w[k][c];
          } else if constexpr (K == 1) {
            acc = cur[c] * w[0][c];
          } else {
            acc = win[0][c] * w[0][c];
#pragma unroll
            for (int k = 1; k < K - 1; ++k) acc += win[k][c] * w[k][c];
            acc += cur[c] * w[K - 1][c];
          }
          acc += bias[c];
          y[c] = silu ? aum::silu_fast(acc) : acc;
        }
        store_row(out + static_cast<long long>(step_of(g0 + j)) * dim, y, nc, kVector);
        if constexpr (K > 1) {
#pragma unroll
          for (int c = 0; c < kVec; ++c) {
#pragma unroll
            for (int i = 0; i + 1 < K - 1; ++i) win[i][c] = win[i + 1][c];
            win[K - 2][c] = cur[c];
          }
        }
      }
    }
  }
}

// The general form: any width K, one window of kGenTaps taps at a time.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kGenThreads)
conv1d_general_kernel(const ConvArgs a, int seqlen, int dim, int width, int reverse, int silu) {
  __shared__ __align__(16) float s_x[kGenTileL + kGenTaps - 1][kGenChannels];
  __shared__ float s_w[kGenTaps][kGenChannels];
  const int c0 = blockIdx.x * kGenChannels;
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kGenTileL;
  const int c = threadIdx.x % kGenChannels;  // this thread's channel of the block
  const int s0 = threadIdx.x / kGenChannels * kGenSteps;  // and its first step
  const T* x = static_cast<const T*>(a.x) + b * a.x_sb;
  // Output step t0 + s sums tap(i) x[base + s + i] over i = 0 .. K-1, tap(i)
  // = i causal, K-1-i anti-causal: the plain version's order.
  const long long base = reverse ? t0 : static_cast<long long>(t0) - (width - 1);
  constexpr int kPer = 16 / sizeof(T);  // channels per 16-byte vector
  float acc[kGenSteps];
#pragma unroll
  for (int j = 0; j < kGenSteps; ++j) acc[j] = 0.0f;

  for (int i0 = 0; i0 < width; i0 += kGenTaps) {
    const int nw = min(kGenTaps, width - i0);  // taps of this window
    const int nrows = kGenTileL + nw - 1;        // rows they reach
    __syncthreads();  // the previous window's readers are done
    // s_x[r] = x[base + i0 + r] of the block's channels; zeros outside the
    // sequence and past D.
    if (kVector) {
      for (int idx = threadIdx.x; idx < nrows * (kGenChannels / kPer); idx += kGenThreads) {
        const int r = idx / (kGenChannels / kPer), v = idx % (kGenChannels / kPer) * kPer;
        const long long t = base + i0 + r;
        const bool in = t >= 0 && t < seqlen && c0 + v < dim;
        float4* dst = reinterpret_cast<float4*>(&s_x[r][v]);
        if constexpr (sizeof(T) == 2) {
          // 8 channels: bf16 pairs, element 2k in the low half.
          const uint4 q = in ? __ldg(reinterpret_cast<const uint4*>(x + t * a.x_sl + c0 + v))
                             : make_uint4(0u, 0u, 0u, 0u);
          dst[0] = make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
                               __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
          dst[1] = make_float4(__uint_as_float(q.z << 16), __uint_as_float(q.z & 0xffff0000u),
                               __uint_as_float(q.w << 16), __uint_as_float(q.w & 0xffff0000u));
        } else {
          dst[0] = in ? __ldg(reinterpret_cast<const float4*>(x + t * a.x_sl + c0 + v))
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
    } else {
      for (int idx = threadIdx.x; idx < nrows * kGenChannels; idx += kGenThreads) {
        const int r = idx / kGenChannels, ch = idx % kGenChannels;
        const long long t = base + i0 + r;
        s_x[r][ch] = t >= 0 && t < seqlen && c0 + ch < dim
                         ? aum::to_float(__ldg(x + t * a.x_sl + c0 + ch))
                         : 0.0f;
      }
    }
    for (int idx = threadIdx.x; idx < nw * kGenChannels; idx += kGenThreads) {
      const int i = idx / kGenChannels, ch = idx % kGenChannels;
      const int tap = reverse ? width - 1 - (i0 + i) : i0 + i;
      s_w[i][ch] = c0 + ch < dim
                       ? param(a.weight, a.w_dtype, static_cast<long long>(c0 + ch) * width + tap)
                       : 0.0f;
    }
    __syncthreads();
    // ring[(i + j) % 16] holds s_x[s0 + i + j][c] at tap i of the window.
    float ring[kGenSteps];
#pragma unroll
    for (int j = 0; j + 1 < kGenSteps; ++j) ring[j] = s_x[s0 + j][c];
    for (int i1 = 0; i1 < nw; i1 += kGenSteps) {
#pragma unroll
      for (int u = 0; u < kGenSteps; ++u) {
        const int i = i1 + u;
        if (i < nw) {
          ring[(u + kGenSteps - 1) % kGenSteps] = s_x[s0 + i + kGenSteps - 1][c];
          const float w = s_w[i][c];
#pragma unroll
          for (int j = 0; j < kGenSteps; ++j) {
            acc[j] = fmaf(w, ring[(u + j) % kGenSteps], acc[j]);
          }
        }
      }
    }
  }
  if (c0 + c >= dim) return;
  const float bias = a.bias != nullptr ? param(a.bias, a.b_dtype, c0 + c) : 0.0f;
  T* out = static_cast<T*>(a.out) + static_cast<long long>(b) * seqlen * dim + c0 + c;
#pragma unroll
  for (int j = 0; j < kGenSteps; ++j) {
    const int t = t0 + s0 + j;
    if (t < seqlen) {
      const float v = acc[j] + bias;
      out[static_cast<long long>(t) * dim] = aum::from_float<T>(silu ? aum::silu_fast(v) : v);
    }
  }
}

template <typename T, bool kReverse, int K>
void launch_dir(const ConvArgs& a, bool vector, dim3 grid, int seqlen, int dim, int silu,
                cudaStream_t s) {
  if (vector) {
    conv1d_fwd_kernel<T, kReverse, true, K><<<grid, kThreads, 0, s>>>(a, seqlen, dim, silu);
  } else {
    conv1d_fwd_kernel<T, kReverse, false, K><<<grid, kThreads, 0, s>>>(a, seqlen, dim, silu);
  }
}

template <typename T, int K>
int launch(const ConvArgs& a, int batch, int seqlen, int dim, int reverse, int silu,
           cudaStream_t s) {
  const long long per16 = 16 / sizeof(T);  // elements per 16 bytes
  const bool vector = dim % kVec == 0 && aum::aligned16(a.x) && aum::aligned16(a.out) &&
                      a.x_sl % per16 == 0 && a.x_sb % per16 == 0;
  const int threads_per_row = (dim + kVec - 1) / kVec;
  const dim3 grid((threads_per_row + kThreads - 1) / kThreads, (seqlen + kTileL - 1) / kTileL,
                  batch);
  if (reverse) {
    launch_dir<T, true, K>(a, vector, grid, seqlen, dim, silu, s);
  } else {
    launch_dir<T, false, K>(a, vector, grid, seqlen, dim, silu, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The general form, for widths past kMaxK.
template <typename T>
int launch_general(const ConvArgs& a, int width, int batch, int seqlen, int dim, int reverse,
                   int silu, cudaStream_t s) {
  const long long per16 = 16 / sizeof(T);
  const bool vector = dim % per16 == 0 && aum::aligned16(a.x) && a.x_sl % per16 == 0 &&
                      a.x_sb % per16 == 0;
  const dim3 grid((dim + kGenChannels - 1) / kGenChannels, (seqlen + kGenTileL - 1) / kGenTileL,
                  batch);
  if (vector) {
    conv1d_general_kernel<T, true><<<grid, kGenThreads, 0, s>>>(a, seqlen, dim, width, reverse,
                                                                 silu);
  } else {
    conv1d_general_kernel<T, false><<<grid, kGenThreads, 0, s>>>(a, seqlen, dim, width, reverse,
                                                                  silu);
  }
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of width `width` (1 .. kMaxK), else the general form.
template <typename T, int K = kMaxK>
int launch_width(const ConvArgs& a, int width, int batch, int seqlen, int dim, int reverse,
                 int silu, cudaStream_t s) {
  if (width == K) return launch<T, K>(a, batch, seqlen, dim, reverse, silu, s);
  if constexpr (K > 1) {
    return launch_width<T, K - 1>(a, width, batch, seqlen, dim, reverse, silu, s);
  }
  return launch_general<T>(a, width, batch, seqlen, dim, reverse, silu, s);
}

}  // namespace

extern "C" {

// The wrapper's constants, read back at load: channels per thread and steps
// per tile (the edges the card checks are sized from), and the widest conv
// with its own instantiation (wider ones take the general form: the wrapper
// counts those launches apart).
int aum_conv_channels_per_thread() { return kVec; }
int aum_conv_tile_steps() { return kTileL; }
int aum_conv_unrolled_widths() { return kMaxK; }

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
  AUM_KERNEL(conv1d_fwd_kernel<__nv_bfloat16, false, true>)
  AUM_KERNEL(conv1d_fwd_kernel<__nv_bfloat16, true, true>)
  AUM_KERNEL(conv1d_fwd_kernel<__nv_bfloat16, false, false>)
  AUM_KERNEL(conv1d_fwd_kernel<__nv_bfloat16, true, false>)
  AUM_KERNEL(conv1d_fwd_kernel<float, false, true>)
  AUM_KERNEL(conv1d_fwd_kernel<float, true, true>)
  AUM_KERNEL(conv1d_fwd_kernel<float, false, false>)
  AUM_KERNEL(conv1d_fwd_kernel<float, true, false>)
  // The other widths, causal, vectorised (the rows above are width 4's).
  AUM_KERNEL(conv1d_fwd_kernel<__nv_bfloat16, false, true, 1>)
  AUM_KERNEL(conv1d_fwd_kernel<__nv_bfloat16, false, true, 2>)
  AUM_KERNEL(conv1d_fwd_kernel<__nv_bfloat16, false, true, 3>)
  AUM_KERNEL(conv1d_fwd_kernel<__nv_bfloat16, false, true, 5>)
  AUM_KERNEL(conv1d_fwd_kernel<__nv_bfloat16, false, true, 8>)
  AUM_KERNEL(conv1d_fwd_kernel<float, false, true, 8>)
#undef AUM_KERNEL
  // The general form (any width past kMaxK).
#define AUM_GEN_KERNEL(...)                                         \
  if (i == n++) {                                                   \
    *name = #__VA_ARGS__;                                           \
    return aum_kernel_resources(__VA_ARGS__, kGenThreads, 0, info); \
  }
  AUM_GEN_KERNEL(conv1d_general_kernel<__nv_bfloat16, true>)
  AUM_GEN_KERNEL(conv1d_general_kernel<__nv_bfloat16, false>)
  AUM_GEN_KERNEL(conv1d_general_kernel<float, true>)
  AUM_GEN_KERNEL(conv1d_general_kernel<float, false>)
#undef AUM_GEN_KERNEL
  return -1;
}

// dtype: 0 = fp32, 1 = bf16 (x and out); any width from 1; the args'
// w_dtype and b_dtype 0 or 1. Returns cudaGetLastError() after the launch (0
// on success); a refused launch never runs.
int aum_causal_conv1d_fwd(const ConvArgs* args, int batch, int seqlen, int dim,
                          int width, int reverse, int silu, int dtype,
                          void* stream) {
  if (batch < 1 || seqlen < 1 || dim < 1 || width < 1 || args->w_dtype < 0 ||
      args->w_dtype > 1 || args->b_dtype < 0 || args->b_dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_width<float>(*args, width, batch, seqlen, dim, reverse, silu, s);
  if (dtype == 1) {
    return launch_width<__nv_bfloat16>(*args, width, batch, seqlen, dim, reverse, silu, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

AUM_DEFINE_ERROR_STRING(aum_conv_error_string)
