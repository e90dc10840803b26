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
// recomputed once from its saved entry state xb, and the adjoint walks back
// over the chunk forming every grad per step. So each a_t is evaluated
// twice, once in the recompute walk (advance) and once in the adjoint (ha
// below, which adjoint_from uses); K2 recomputes on two levels and evaluates
// it three times.
//
// Lanes: K2's layout (a chain (batch, channel, direction) over 4 lanes of 4
// states; 8 channels per warp) and its adjoint step (scan_bwd.cuh). A block
// is kWarps = 2 warps, 16 channels of one batch row and direction (grid =
// (ceil(D / 16), batch, directions)).
//
// Two chains per lane. The chunks are processed last first. In pair c a lane
// runs the adjoint of chunk c and, step by step beside it, the recompute walk
// of chunk c - 1, which starts from its own saved xb entry and so depends on
// nothing of chunk c: two independent dependent chains in flight per lane.
// Iteration k = 0 .. 63 of pair c takes the adjoint's step 63 - k of chunk c
// and the walk's step k of chunk c - 1.
//
// Where the states live. A chunk's steps fall in kSlots = 16 groups of kHold
// = 4; one slot (fp32, the block's 64 lanes x 4 states, 1 KB) holds the state
// before a group's first step, and the walk writes it there on entering the
// group. The adjoint, entering a group (its last first), reads the slot,
// evaluates a_t of the group's 4 steps forward and the states before them
// (the walk's own recurrence, one FMA per state) into registers (ha, hx),
// then takes the 4 steps last first from those registers. Slot order: group
// m of chunk c lies in slot m when c is even and in slot 15 - m when c is
// odd. Iteration k = 4 h' of pair c is where the walk enters group h' of
// chunk c - 1 and the adjoint enters group 15 - h' of chunk c: one slot,
// read by the adjoint just before the walk writes it. A lane reads and writes
// only its own column, so no barrier orders the two, and one 16 KB buffer
// serves both chains.
// The chunk that is processed first is the last one, the only one that may be
// short (len < 64; one step at L = 513). The walk of that chunk comes first
// (pair n_chunks, walk only) and writes the slots of its sub-chunks of kSub
// = 8 steps that hold a step (groups m < 2 ceil(len / 8)); in the next pair
// the adjoint of it enters only those groups (as 15 - h' for the walk's h'),
// and the walk of the chunk before writes the other slots in the
// iterations where the adjoint is idle. So the mirror holds for the short
// chunk too, and the exposed walk is one short chunk's sub-chunks, plus the
// adjoint of chunk 0 alone at the end. Steps past L inside a sub-chunk run
// on zero streams (dt = 0: a = 1, nothing added, lam passed on exactly) and
// are not written.
//
// Staging: every sub-chunk of kSub steps stages, for the block's 16
// channels, the adjoint's dt, u, z, g and B_t, C_t rows, and the walk's dt,
// u and B_t rows, in the stream dtype (exact: they arrive so), 72 rows of 16
// values, each element loaded once per block by 16-byte cp.async (value by
// value where a source's rows are not whole 16-byte vectors), into one of
// two buffers: the next sub-chunk's copies are issued while this one runs,
// and write_own reads the staged copy. A thread copies for a fixed few of
// the 9 row groups and holds the addresses of their sources alone. The next
// walk's entry state is copied from xb into shared memory (4-byte cp.async)
// a pair ahead. One barrier per sub-chunk orders the staging and the dB/dC
// row sum: each warp writes its share of every step's row to shared memory;
// after the barrier warp w adds the two shares of the steps j with j % 2 = w,
// and writes the block's row (fp32 partials (ceil(D / 16), batch, L, 32),
// summed by the wrapper). dA, dD and dbias are register accumulators, one
// partial per batch row as in K2.
//
// Per block: 16 KB of slots, 4 KB of dB/dC shares, 1 KB of the next entry
// state, 2 x 2.25 KB (bf16) or 2 x 4.5 KB (fp32) of staged rows: 26,112 or
// 30,720 bytes of shared memory. __launch_bounds__(64, 6) caps registers at
// 168 for 6 blocks (12 warps) per SM: every form fits without spills, the
// 32 registers of a group's a_t and states included. Registers set the
// time: what a lane keeps live beside the two chains (source addresses,
// the next entry state, the dB/dC shares) was moved out of them for that
// reason, and the kernel ran faster at the same cap with each move. A cap
// of 128 (16 warps) spills and runs slower; groups of 8 (8 KB of slots, 64
// registers held) and of 2 (32 KB, 10 warps) run slower too
// (chip_smoke.probe_fused_bwd builds them by AUM_FUSED_HOLD and
// AUM_FUSED_MIN_BLOCKS).
//
// What bounds it: the same function as K2, so the same bound (one exp2 and
// about a dozen FP32-pipe instructions per (b, l, d, n) element and
// direction: operations, not bytes). At 12 warps per SM its time is the
// latency of each lane's adjoint chain (shuffles, SFU, shared loads), which
// the walk beside it hides only in part; each step's shuffles (13 per lane)
// and SFU work (about 10 per lane) are its throughput costs beside the FP32
// pipe.
//
// AUM_FUSED_PROBE (exploratory builds only, never a library the port loads:
// their outputs are wrong) selects a piece of the work for timing it alone:
// 1 the walk without the adjoint's arithmetic, 2 the adjoint without the
// walk, 3 every per-step stream (dt, u, z, g) loaded lane by lane from
// global memory at the start of each sub-chunk instead of staged.

#include <climits>
#include <cstdint>
#include <type_traits>

#include "scan_bwd.cuh"

#ifndef AUM_FUSED_PROBE
#define AUM_FUSED_PROBE 0
#endif
#ifndef AUM_FUSED_HOLD
#define AUM_FUSED_HOLD 4
#endif
#ifndef AUM_FUSED_MIN_BLOCKS
#define AUM_FUSED_MIN_BLOCKS 6
#endif

namespace {

using namespace aum::bwd;

constexpr int kProbe = AUM_FUSED_PROBE;
constexpr int kWarps = 2;                             // warps per block
constexpr int kThreads = kWarp * kWarps;              // 64
constexpr int kChanPerBlock = kChanPerWarp * kWarps;  // 16, one partial row
constexpr int kNSub = kChunk / kSub;                  // sub-chunks per chunk
constexpr int kMinBlocks = AUM_FUSED_MIN_BLOCKS;  // blocks per SM the registers allow
constexpr int kHold = AUM_FUSED_HOLD;  // steps per slot, held in registers by the adjoint
constexpr int kSlots = kChunk / kHold;  // slots per chunk
constexpr int kHoldPerSub = kSub / kHold;
static_assert(kSub % kHold == 0, "a sub-chunk holds whole groups of kHold steps");
constexpr int kSlot = kNL * kThreads;  // floats of one slot

// The staged rows of a sub-chunk: groups of kSub rows (one per step) of the
// adjoint (chunk c) and of the walk (chunk c - 1).
enum Group { kAdt, kAu, kAz, kAg, kAB, kAC, kWdt, kWu, kWB, kGroups };
constexpr int kAdjGroups = kWdt;
constexpr int kRowLen = kChanPerBlock;  // values per row: channels, or n of B/C
static_assert(kRowLen == kMaxN, "channel rows and B/C rows share one width");
// Which of the sources (dt, u, z, g, B, C) a group copies.
__host__ __device__ constexpr int source_of(int g) {
  return g < kAdjGroups ? g : (g == kWB ? 4 : g - kAdjGroups);
}

template <typename T>
struct Smem {
  float x[kSlots][kNL][kThreads];  // the slots: the states before every kHold-th step
  float dbc[2][kSub][kWarps][kRow];  // each warp's share of each dB/dC row
  float xn[kNL][kThreads];           // the next walk's entry state
  T st[2][kGroups][kSub][kRowLen];
};

// One source of staged rows, at step 0 of the block's batch row (and its
// first channel): rows sl apart, `valid` values each (the rest stage as
// zeros); `vec`: every row is whole 16-byte vectors.
template <typename T>
struct Source {
  const T* base;
  int sl;  // the C entry refuses row strides past INT_MAX
  int valid;
  bool vec;
};

template <typename T>
__device__ __forceinline__ Source<T> source(const void* ptr, long long offset, int sl,
                                            int valid) {
  constexpr int kVec = 16 / sizeof(T);
  const T* base = static_cast<const T*>(ptr) + offset;
  return {base, sl, valid,
          aum::aligned16(base) && (sl * sizeof(T)) % 16 == 0 && valid % kVec == 0};
}

// 16 bytes from global to shared memory, the last 16 - src_bytes zeros
// (src_bytes 0 or 16 here: nothing is read at 0).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
// 4 bytes, zeros where src_bytes is 0.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// This lane's kNL values of a staged B/C row, as floats, in one load.
struct Row4 {
  float v[kNL];
  __device__ __forceinline__ float operator[](int k) const { return v[k]; }
};
static_assert(kNL == 4, "Row4 holds a lane's four states");
__device__ __forceinline__ Row4 row4(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  return {{a.x, a.y, a.z, a.w}};
}
__device__ __forceinline__ Row4 row4(const __nv_bfloat16* p) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);  // element 2k in the low half
  return {{__uint_as_float(a.x << 16), __uint_as_float(a.x & 0xffff0000u),
           __uint_as_float(a.y << 16), __uint_as_float(a.y & 0xffff0000u)}};
}

// A sub-chunk of pair c (the adjoint of chunk c, the walk of chunk c - 1):
// its index s in the pair, which chains run, the adjoint's processed index
// of its step 0 and its steps before L.
struct Sub {
  int c, s;
  bool adj, walk;
  int i0, alen;
};

// kSoftplus: dt came through the softplus; kBf16Part: bf16 dB/dC partials.
template <typename T, bool kSoftplus, bool kBf16Part = false>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_bwd_fused_kernel(const ScanBwdArgs args, int batch, int seqlen, int dim, int dstate) {
  using Part = std::conditional_t<kBf16Part, __nv_bfloat16, float>;
  extern __shared__ float4 smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);

  const ScanBwdDir& p = args.dir[blockIdx.z];
  const bool reverse = p.reverse != 0;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int q = lane % kGroup;  // this lane's states: n = q * kNL + k
  const int ch = lane / kGroup;
  const int chb = warp * kChanPerWarp + ch;  // this lane's channel in the block
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChanPerBlock;
  const int d = d0 + chb;
  const bool active = d < dim;
  const int dc = active ? d : 0;  // inactive channels compute on zeros
  const int n0 = q * kNL;
  const int row_pos = row_position(ch, n0);

  const long long row = static_cast<long long>(b) * seqlen * dim + dc;
  T* du = static_cast<T*>(p.du) + row;
  T* ddelta = static_cast<T*>(p.ddelta) + row;
  T* dz = static_cast<T*>(p.dz) + row;
  Part* dbc = static_cast<Part*>(p.dbc_part) +
              (static_cast<long long>(blockIdx.x) * batch + b) * seqlen * kRow;
  const int n_chunks = (seqlen + kChunk - 1) / kChunk;
  auto step_of = [&](int i) { return reverse ? seqlen - 1 - i : i; };


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

  // The live sub-chunks in order: the walk of the last chunk (pair
  // n_chunks), then pairs n_chunks - 1 .. 1 whole (the walk of a full
  // chunk; the adjoint where its chunk has steps), then the adjoint of
  // chunk 0.
  const int last_len = seqlen - (n_chunks - 1) * kChunk;
  const int first_subs = (last_len + kSub - 1) / kSub;
  const int final_subs = n_chunks == 1 ? first_subs : kNSub;
  const int n_live = first_subs + kNSub * (n_chunks - 1) + final_subs;
  auto locate = [&](int it) {
    Sub u;
    if (it < first_subs) {
      u.c = n_chunks;
      u.s = it;
    } else if ((it -= first_subs) < kNSub * (n_chunks - 1)) {
      u.c = n_chunks - 1 - it / kNSub;
      u.s = it % kNSub;
    } else {
      u.c = 0;
      u.s = kNSub - final_subs + it - kNSub * (n_chunks - 1);
    }
    const int len = u.c == n_chunks - 1 ? last_len : kChunk;
    const int a0 = (kNSub - 1 - u.s) * kSub;  // the adjoint's first step in its chunk
    u.adj = u.c < n_chunks && a0 < len;
    u.walk = u.c > 0;
    u.i0 = u.c * kChunk + a0;
    u.alen = u.adj ? min(kSub, len - a0) : 0;
    return u;
  };

  // Each thread copies granule gi of the groups g = pass + m kPasses, from
  // the sources of those groups alone (mine[m]: 3 of the 6 in bf16).
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kGranPerGroup = kSub * kRowLen / kVec;
  constexpr int kPasses = kThreads / kGranPerGroup;
  constexpr int kMine = (kGroups + kPasses - 1) / kPasses;
  static_assert(kThreads % kGranPerGroup == 0, "a group's granules fill whole threads");
  const int pass = tid / kGranPerGroup;
  Source<T> mine[kMine];
  {
    const int dvalid = min(kChanPerBlock, dim - d0);
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      switch (source_of(min(pass + m * kPasses, kGroups - 1))) {
        case 0: mine[m] = source<T>(p.dt, b * p.dt_sb + d0, p.dt_sl, dvalid); break;
        case 1: mine[m] = source<T>(p.u, b * p.u_sb + d0, p.u_sl, dvalid); break;
        case 2: mine[m] = source<T>(p.z, b * p.z_sb + d0, p.z_sl, dvalid); break;
        case 3: mine[m] = source<T>(p.g, b * p.g_sb + d0, p.g_sl, dvalid); break;
        case 4: mine[m] = source<T>(p.B, b * p.B_sb, p.B_sl, dstate); break;
        default: mine[m] = source<T>(p.C, b * p.C_sb, p.C_sl, dstate); break;
      }
    }
  }
  // Issue the copies of sub-chunk u into buffer buf, steps past L as zeros.
  auto stage = [&](int buf, const Sub& u) {
    const int gi = tid % kGranPerGroup;
    const int j = gi / (kRowLen / kVec);
    const int v0 = gi % (kRowLen / kVec) * kVec;
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      const int g = pass + m * kPasses;
      const bool adj_row = g < kAdjGroups;
      if (g >= kGroups || (adj_row ? !u.adj : !u.walk)) continue;
      if (kProbe == 3 && source_of(g) < 4) continue;  // the probe reads these itself
      const Source<T>& sr = mine[m];
      const int i = adj_row ? u.i0 + j : (u.c - 1) * kChunk + u.s * kSub + j;
      const bool in = i < seqlen;
      const T* from = sr.base + (in ? static_cast<long long>(step_of(i)) * sr.sl : 0) + v0;
      T* to = &sm.st[buf][g][j][v0];
      if (sr.vec) {
        cp_async16(to, from, in && v0 < sr.valid ? 16 : 0);
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          to[v] = in && v0 + v < sr.valid ? from[v] : aum::from_float<T>(0.0f);
        }
      }
    }
    cp_async_commit();
  };

  // The walk's state; the next walk's entry state is copied into sm.xn a
  // pair ahead (in the second sub-chunk of a pair, once the first has read
  // the previous one).
  auto xb_at = [&](int c) {
    return p.xb + ((static_cast<long long>(b) * n_chunks + c) * dstate + n0) * dim + dc;
  };
  auto copy_xn = [&](int c) {
    const float* xb = xb_at(c);
#pragma unroll
    for (int k = 0; k < kNL; ++k) {
      cp_async4(&sm.xn[k][tid], xb + static_cast<long long>(k) * dim, has_n[k] ? 4 : 0);
    }
  };
  float xw[kNL];
#pragma unroll
  for (int k = 0; k < kNL; ++k) {
    xw[k] = has_n[k] ? xb_at(n_chunks - 1)[static_cast<long long>(k) * dim] : 0.0f;
  }
  if (n_chunks > 1) copy_xn(n_chunks - 2);  // committed with sub-chunk 0's rows

  // After the barrier warp w sums the two warps' shares of the dB/dC rows
  // of the steps j with j % 2 == w.
  auto finalize = [&](const Sub& u, int buf) {
#pragma unroll
    for (int h = 0; h < kSub / 2; ++h) {
      const int j = 2 * h + warp;
      if (j < u.alen) {
        dbc[static_cast<long long>(step_of(u.i0 + j)) * kRow + row_pos] =
            aum::from_float<Part>(sm.dbc[buf][j][warp][row_pos] +
                                  sm.dbc[buf][j][warp ^ 1][row_pos]);
      }
    }
  };

  Sub prev{};
  stage(0, locate(0));
  for (int it = 0; it < n_live; ++it) {
    const Sub u = locate(it);
    const int buf = it & 1;
    cp_async_wait_all();
    // Sub-chunk it is staged; every thread is done with sub-chunk it - 1,
    // so its buffer and the dB/dC shares of sub-chunk it - 2 are free.
    __syncthreads();
    if (prev.alen > 0) finalize(prev, buf ^ 1);
    if (it + 1 < n_live) stage(buf ^ 1, locate(it + 1));
    if (u.walk && u.s == 0 && u.c < n_chunks) {  // a full walk starts: chunk c - 1
#pragma unroll
      for (int k = 0; k < kNL; ++k) xw[k] = sm.xn[k][tid];
    }
    if (u.walk && u.s == 1 && u.c < n_chunks && u.c >= 2) {
      copy_xn(u.c - 2);  // committed with the next sub-chunk's rows
    }

    // The slot of the walk's group h (its steps s kSub + h kHold + e) and of
    // the adjoint's group kHoldPerSub - 1 - h of this sub-chunk.
    const bool mirror = ((u.c - 1) & 1) != 0;
    const int m0 = u.s * kHoldPerSub;
    float* xs = &sm.x[mirror ? kSlots - 1 - m0 : m0][0][tid];
    const int xstep = mirror ? -kSlot : kSlot;
    const auto& st = sm.st[buf];

    // The probe's per-lane global loads of the streams (kProbe == 3): the
    // sub-chunk's, at its start; write_own's again (from L1).
    const T* lane_src[4] = {static_cast<const T*>(p.dt) + b * p.dt_sb + dc,
                            static_cast<const T*>(p.u) + b * p.u_sb + dc,
                            static_cast<const T*>(p.z) + b * p.z_sb + dc,
                            static_cast<const T*>(p.g) + b * p.g_sb + dc};
    const long long lane_sl[4] = {p.dt_sl, p.u_sl, p.z_sl, p.g_sl};
    auto global = [&](int g, int i, bool on) {
      return load(lane_src[g], step_of(min(i, seqlen - 1)) * lane_sl[g],
                  active && on && i < seqlen);
    };
    [[maybe_unused]] float gl[kGroups - 3][kSub];
    if constexpr (kProbe == 3) {
      const int k0 = u.s * kSub;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
#pragma unroll
        for (int g = 0; g < 4; ++g) gl[g][j] = global(g, u.i0 + j, u.adj);
        gl[4][j] = global(0, (u.c - 1) * kChunk + k0 + j, u.walk);
        gl[5][j] = global(1, (u.c - 1) * kChunk + k0 + j, u.walk);
      }
    }
    // Stream g (kAdt .. kAg, kWdt, kWu) of step j (a constant after unrolling).
    auto sval = [&](int g, int j) {
      if constexpr (kProbe == 3) return gl[g < kAdjGroups ? g : g - 2][j];
      return aum::to_float(st[g][j][chb]);
    };

    auto run = [&](auto adj_on, auto walk_on) {
      constexpr bool kAdj = decltype(adj_on)::value && kProbe != 1;
      constexpr bool kWalk = decltype(walk_on)::value && kProbe != 2;
      OwnSteps own;
#pragma unroll
      for (int h = 0; h < kHoldPerSub; ++h) {
        float* slot = xs + h * xstep;
        // The adjoint's group: steps jb .. jb + kHold - 1 of its sub-chunk,
        // from the state before step jb (its slot, read before the walk
        // writes it): a_t of each step and the state before it, forward.
        const int jb = kSub - (h + 1) * kHold;
        [[maybe_unused]] float ha[kHold][kNL], hx[kHold][kNL];
        if constexpr (kAdj) {
#pragma unroll
          for (int k = 0; k < kNL; ++k) hx[0][k] = slot[k * kThreads];
#pragma unroll
          for (int e = 0; e < kHold; ++e) {
            const float dtv = sval(kAdt, jb + e);
            const float dtl = dtv * kLog2e;
#pragma unroll
            for (int k = 0; k < kNL; ++k) ha[e][k] = aum::exp2_sfu(dtl * A[k]);
            if (e + 1 < kHold) {
              const float dtu = dtv * sval(kAu, jb + e);
              const Row4 bt = row4(&st[kAB][jb + e][n0]);
#pragma unroll
              for (int k = 0; k < kNL; ++k) hx[e + 1][k] = ha[e][k] * hx[e][k] + dtu * bt[k];
            }
          }
        }
        if constexpr (kWalk) {
#pragma unroll
          for (int k = 0; k < kNL; ++k) slot[k * kThreads] = xw[k];
        }
#pragma unroll
        for (int e = 0; e < kHold; ++e) {
          if constexpr (kAdj) {
            const int j = jb + kHold - 1 - e;  // last first
            const float v = adjoint_from(j, ha[j - jb], hx[j - jb], row4(&st[kAB][j][n0]),
                                         row4(&st[kAC][j][n0]), A, lam, dA, dD, own,
                                         sval(kAdt, j), sval(kAu, j), sval(kAz, j),
                                         sval(kAg, j), dskip, lane);
            sm.dbc[buf][j][warp][row_pos] = v;
          }
          if constexpr (kWalk) {
            const int w = h * kHold + e;
            advance(xw, A, row4(&st[kWB][w][n0]), sval(kWdt, w), sval(kWu, w));
          }
        }
      }
      if constexpr (kAdj) {
        auto streams = [&](int j, float& dtv, float& uv, float& zv, float& gv) {
          float v[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            v[g] = kProbe == 3 ? global(g, u.i0 + j, true) : aum::to_float(st[g][j][chb]);
          }
          dtv = v[kAdt];
          uv = v[kAu];
          zv = v[kAz];
          gv = v[kAg];
        };
        write_own<T, kSoftplus>(own, streams, du, ddelta, dz, u.i0, u.alen, seqlen, reverse,
                                dim, dskip, active, q, dbias);
      }
    };
    if (u.adj && u.walk) {
      run(std::true_type{}, std::true_type{});
    } else if (u.adj) {
      run(std::true_type{}, std::false_type{});
    } else {
      run(std::false_type{}, std::true_type{});
    }
    prev = u;
  }
  __syncthreads();
  if (prev.alen > 0) finalize(prev, (n_live - 1) & 1);

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
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem<T>));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((dim + kChanPerBlock - 1) / kChanPerBlock, batch, ndir);
  kernel<<<grid, kThreads, sizeof(Smem<T>), s>>>(args, batch, seqlen, dim, dstate);
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
#define AUM_KERNEL(T, ...)                                                             \
  if (i == n++) {                                                                      \
    *name = "scan_bwd_fused_kernel<" #T ", " #__VA_ARGS__ ">";                         \
    const auto kernel = scan_bwd_fused_kernel<T, __VA_ARGS__>;                         \
    const cudaError_t err = cudaFuncSetAttribute(                                      \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem<T>));         \
    if (err != cudaSuccess) return static_cast<int>(err);                              \
    return aum_kernel_resources(kernel, kThreads, sizeof(Smem<T>), info);              \
  }
  AUM_KERNEL(__nv_bfloat16, true)
  AUM_KERNEL(__nv_bfloat16, false)
  AUM_KERNEL(float, true)
  AUM_KERNEL(float, false)
  // bf16 partials, through the softplus or not.
  AUM_KERNEL(__nv_bfloat16, true, true)
  AUM_KERNEL(float, true, true)
  AUM_KERNEL(__nv_bfloat16, false, true)
  AUM_KERNEL(float, false, true)
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
    for (const long long sl : {p.dt_sl, p.u_sl, p.z_sl, p.g_sl, p.B_sl, p.C_sl}) {
      if (sl < 0 || sl > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(*args, ndir, batch, seqlen, dim, dstate, s);
  if (dtype == 1) return launch<__nv_bfloat16>(*args, ndir, batch, seqlen, dim, dstate, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

AUM_DEFINE_ERROR_STRING(aum_scan_bwd_fused_error_string)
