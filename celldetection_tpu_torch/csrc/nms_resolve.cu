// Resolve of greedy NMS, for Hopper (sm_90a): the sequential half of the
// sweep, over the suppression bits that nms_bits.cu wrote.
//
// Replaces, with nms_bits.cu: celldetection_tpu/kernels/nms_pallas.py:
// _nms_kernel (the Pallas TPU kernel that nms_pallas_impl launches): its
// in-tile greedy and its clearing of later boxes.
//
// What it computes. Box i of an image is kept iff it is valid and no kept box
// before it suppresses it. The image's boxes are walked in blocks of 64, in
// order. `removed` [B, nb] u64 holds bit l of word c iff box 64c + l is
// suppressed by a kept box of an earlier block. For block r the live rows are
// valid & ~removed[r]; the greedy inside the block runs over the boxes'
// column words of their own block (diag [B, nb * 64], see nms_bits.cu), whose
// own bit says the box is valid; then each kept row ORs its later words, the
// pairs {bits, row, word} of nms_bits_fill, into `removed`. Block r's pairs
// for image b are one segment: packed, [start[q], start[q + 64]) less the
// band's first offset `base`, where q = (r * B + b) * 64; in the slots layout
// of small images, its 64 * (nb - 1 - r) slots, zero where a word is zero
// (see nms_common.cuh).
// One launch walks the row blocks [r0, r1) of one band; `removed` starts at
// zero (r0 = 0) or carries from the band before in device memory, and keep
// [B, n] is written block by block.
//
// What bounds it on this card: the chain. Block r's keep bits depend on every
// kept box before it, so the n / 64 steps run one after another. The bytes
// (diag 8 B per box, 16 B per pair, keep 1 B per box) and the operations are
// small beside the latency of a step.
//
// What the design does about it:
//   - one CTA per image, all images in one launch; the image's removed bits
//     live in shared memory (n / 64 words: 32 KB at n = 262,144), so a step
//     touches device memory only to read its own block's words and pairs,
//     never the box table;
//   - warp 0 alone walks the chain. Warps 1-31 stage the words and pairs of
//     the block two ahead in shared memory by cp.async (a ring of four stages
//     of up to 2,048 pairs; a main-path block has at most 64 x 31 = 1,984)
//     and OR the kept rows of the block before into the removed bits
//     (atomicOr) while warp 0 resolves the current one: the latency of device
//     memory and the ORs leave the chain, and a step is one barrier;
//   - warp 0 resolves a block without a serial walk over its rows: lane l
//     holds the column words of boxes l and 32 + l (the earlier boxes of the
//     block that suppress them), and all 64 keep bits are updated at once
//     from the current guess by two ballots, until they stop changing. That
//     takes as many rounds as the longest chain of suppressions in the block
//     (a few), not one round per kept row;
//   - the ORs of block r - 1 may still be landing in word r while warp 0
//     reads it: warp 0 ORs the kept rows' words of the next block itself
//     (`carry`, from nms_bits.cu's next words or the first slot of each row),
//     so the block it resolves never waits for them.
//
// Large images (`large`, more than 4,096 blocks: kernels/nms.py:large_layout)
// take a variant whose removed bits still live in shared memory, beside a ring
// of stages that hold 1,024 pairs each instead of 2,048 (a stitch-scale block
// holds a few hundred), and which reads each block's segment bounds from
// `start` in device memory when it stages or ORs the block, instead of keeping
// them in shared memory: up to 2^20 boxes (16,384 blocks) fit.
//
// Scratch bound: nothing of its own. Shared memory: 4 x 33,792 bytes of
// stages, n / 64 * 8 bytes of removed bits and 8 bytes per row block of
// segment bounds (200,704 bytes at n = 262,144); large, 4 x 17,408 bytes of
// stages and the removed bits (200,704 bytes at n = 2^20, the wrapper's
// largest).
//
// Built with -DCDT_NMS_TRACE (kernels/nms.py: resolve_library(trace=True)),
// the kernel also sums CTA 0's clock cycles by phase of the walk, for warp 0
// and for the other warps, which scripts/torch_nms_resolve_steps.py reads
// through cdt_nms_resolve_phases. The wrappers use the plain build.
#include <cuda_runtime.h>
#include <stdint.h>

#include "nms_common.cuh"

namespace {

using cdt_nms::kBlock;
using cdt_nms::Pair;
using cdt_nms::slot_of;

constexpr int kThreads = 1024;  // threads per CTA: warp 0 resolves, warps 1-31 stage and OR

constexpr int kStages = 4;   // the block ORed, the block resolved and the next two
// pairs of a block staged in shared memory (a main-path block has at most
// 64 x 31 = 1,984); the rest are read directly. Large images stage fewer.
constexpr int kCapSmall = 2048;
constexpr int kCapLarge = 1024;

// Phases of the walk, for the instrumented build's clock sums.
enum Phase {
  kSetup,   // before the walk: removed bits, segment bounds, the first two stages
  kWait,    // each step: the cp.async wait and the barrier
  kWork,    // each step: warp 0's ballot rounds; the others stage block r + 2
  kTail,    // each step: warp 0's keep bytes and carry; the others OR block r - 1
  kFinish,  // after the walk: the last block's ORs and the removed bits written back
  kPhases
};

#ifdef CDT_NMS_TRACE
// CTA 0's sums of its last launch: [warp 0, other warps][phase], then warp 0's
// ballot rounds in [0][kPhases]
__device__ long long phase_cycles[2][kPhases + 1];

struct PhaseClock {  // kept by every thread; threads 0 and 32 report
  long long sum[kPhases + 1] = {};
  long long tick;
  __device__ PhaseClock() { tick = clock64(); }
  __device__ void mark(int k) {
    const long long now = clock64();
    sum[k] += now - tick;
    tick = now;
  }
  __device__ void count() { ++sum[kPhases]; }
  __device__ void save(int t) {
    if (blockIdx.x == 0 && (t == 0 || t == 32))
      for (int k = 0; k <= kPhases; ++k) phase_cycles[t / 32][k] = sum[k];
  }
};
#else
struct PhaseClock {  // the plain build: no clock is read
  __device__ void mark(int) {}
  __device__ void count() {}
  __device__ void save(int) {}
};
#endif

template <int kCap>
struct Stage {
  Pair pairs[kCap];                 // the block's first kCap pairs
  unsigned long long cols[kBlock];  // the block's column words (own bit: valid)
  unsigned long long next[kBlock];  // packed: each row's word of the next block
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

template <bool kLarge>
__global__ void __launch_bounds__(kThreads)
nms_resolve_kernel(const unsigned long long* __restrict__ diag,
                   const unsigned long long* __restrict__ nxt, const Pair* __restrict__ pairs,
                   const long long* __restrict__ start, long long base,
                   unsigned long long* __restrict__ removed_g, uint8_t* __restrict__ keep, int n,
                   int nb, int r0, int r1) {
  constexpr int kCap = kLarge ? kCapLarge : kCapSmall;
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<kCap>* const stages = reinterpret_cast<Stage<kCap>*>(smem);
  unsigned long long* const removed = reinterpret_cast<unsigned long long*>(stages + kStages);
  int* const seg_lo = reinterpret_cast<int*>(removed + nb);  // each block's pairs, relative
  int* const seg_hi = seg_lo + (r1 - r0);                     // to `base` (not large)
  __shared__ unsigned long long kept_bits[2];                 // of blocks r and r - 1
  PhaseClock clk;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const size_t img = static_cast<size_t>(b) * n;
  diag += static_cast<size_t>(b) * nb * kBlock;  // [B, nb * 64]
  if (nxt) nxt += static_cast<size_t>(b) * nb * kBlock;
  keep += img;
  if (removed_g) removed_g += static_cast<size_t>(b) * nb;
  for (int w = t; w < nb; w += kThreads) removed[w] = r0 ? removed_g[w] : 0ull;
  // block r's pairs: packed, [start[q], start[q + 64]) - base with
  // q = (r * B + b) * 64; slots, its 64 * (nb - 1 - r) slots. A band holds at
  // most PAIR_BUDGET pairs, or one row block's (kernels/nms.py): int offsets.
  for (int r = r0 + t; !kLarge && r < r1; r += kThreads) {
    const size_t q = (static_cast<size_t>(r) * gridDim.x + b) * kBlock;
    seg_lo[r - r0] = static_cast<int>(start ? start[q] - base : slot_of(r, b, gridDim.x, nb));
    seg_hi[r - r0] = static_cast<int>(start ? start[q + kBlock] - base
                                            : seg_lo[r - r0] + kBlock * (nb - 1 - r));
  }
  // block r's pairs [lo, hi) relative to `base`; large images are packed
  auto bounds = [&](int r, int& lo, int& hi) {
    if (kLarge) {
      const size_t q = (static_cast<size_t>(r) * gridDim.x + b) * kBlock;
      lo = static_cast<int>(start[q] - base);
      hi = static_cast<int>(start[q + kBlock] - base);
    } else {
      lo = seg_lo[r - r0];
      hi = seg_hi[r - r0];
    }
  };
  // stage block r by cp.async, 16 bytes a copy, spread over the threads
  // [first, first + stride): its column words, next words (packed) and first
  // kCap pairs
  auto stage = [&](int r, int first, int stride) {
    if (r >= r1) return;
    Stage<kCap>& st = stages[r % kStages];
    const size_t row0 = static_cast<size_t>(r) * kBlock;
    for (int x = first; x < kBlock / 2; x += stride) {
      cp_async16(&st.cols[2 * x], diag + row0 + 2 * x);
      if (start) cp_async16(&st.next[2 * x], nxt + row0 + 2 * x);
    }
    int lo, hi;
    bounds(r, lo, hi);
    for (int p = first; p < kCap && lo + p < hi; p += stride)
      cp_async16(&st.pairs[p], pairs + lo + p);
  };
  // the kept rows of block r OR their later words into removed
  auto apply = [&](int r, int first, int stride) {
    const Stage<kCap>& st = stages[r % kStages];
    const unsigned long long kb = kept_bits[r & 1];
    if (!kb) return;
    int lo, hi;
    bounds(r, lo, hi);
    for (int p = first; lo + p < hi; p += stride) {
      const Pair pr = p < kCap ? st.pairs[p] : pairs[lo + p];
      if (pr.bits && ((kb >> ((pr.row - static_cast<int>(img)) & (kBlock - 1))) & 1ull))
        atomicOr(&removed[pr.word], pr.bits);
    }
  };
  __syncthreads();
  stage(r0, t, kThreads);
  asm volatile("cp.async.commit_group;\n" ::);
  stage(r0 + 1, t, kThreads);
  asm volatile("cp.async.commit_group;\n" ::);
  clk.mark(kSetup);

  unsigned long long carry = 0ull;  // warp 0: word r's bits removed by the kept rows of r - 1
  for (int r = r0; r < r1; ++r) {
    // block r's copies are done (block r + 1's may still fly); block r - 1's
    // keep bits and block r - 2's ORs are published; block r + 2 takes the
    // stage of block r - 2. Warp 0 alone walks the chain; the other warps
    // stage and OR beside it.
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    clk.mark(kWait);

    if (t < 32) {
      // greedy over the block: box l is kept iff it is live and no kept box
      // before it in the block suppresses it. Iterated from K = live, every
      // lane updates its two boxes at once; boxes 0..k are final after k + 1
      // rounds, so it stops at the fixed point, the greedy's unique answer,
      // after at most 65 rounds and in practice after the longest chain of
      // suppressions in the block. Word r may still be receiving block
      // r - 1's ORs from the other warps: `carry` holds those bits already.
      const Stage<kCap>& st = stages[r % kStages];
      const unsigned long long own0 = 1ull << t, own1 = 1ull << (t + 32);
      const unsigned long long c0 = st.cols[t], c1 = st.cols[t + 32];
      const unsigned long long gone = removed[r] | carry;
      // each row's word of block r + 1: packed, its next word; slots, its first slot
      const int w = nb - 1 - r;
      const unsigned long long n0 = !w ? 0ull : start ? st.next[t] : st.pairs[t * w].bits;
      const unsigned long long n1 =
          !w ? 0ull : start ? st.next[t + 32] : st.pairs[(t + 32) * w].bits;
      const bool l0 = (c0 & own0) && !(gone & own0), l1 = (c1 & own1) && !(gone & own1);
      const unsigned long long s0 = c0 & ~own0, s1 = c1 & ~own1;
      unsigned long long k =
          (static_cast<unsigned long long>(__ballot_sync(0xffffffffu, l1)) << 32) |
          __ballot_sync(0xffffffffu, l0);
      while (true) {
        const unsigned long long next =
            (static_cast<unsigned long long>(__ballot_sync(0xffffffffu, l1 && !(s1 & k))) << 32) |
            __ballot_sync(0xffffffffu, l0 && !(s0 & k));
        clk.count();
        if (next == k) break;
        k = next;
      }
      clk.mark(kWork);
      const int i0 = r * kBlock + t;
      if (i0 < n) keep[i0] = static_cast<uint8_t>((k >> t) & 1ull);
      if (i0 + 32 < n) keep[i0 + 32] = static_cast<uint8_t>((k >> (t + 32)) & 1ull);
      if (t == 0) kept_bits[r & 1] = k;
      // the kept rows' words of block r + 1, ORed across the warp
      const unsigned long long c =
          (((k >> t) & 1ull) ? n0 : 0ull) | (((k >> (t + 32)) & 1ull) ? n1 : 0ull);
      carry = (static_cast<unsigned long long>(
                   __reduce_or_sync(0xffffffffu, static_cast<unsigned>(c >> 32))) << 32) |
              __reduce_or_sync(0xffffffffu, static_cast<unsigned>(c));
      clk.mark(kTail);
    } else {
      stage(r + 2, t - 32, kThreads - 32);
      clk.mark(kWork);
      if (r > r0) apply(r - 1, t - 32, kThreads - 32);
      clk.mark(kTail);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  apply(r1 - 1, t, kThreads);
  __syncthreads();

  if (removed_g)  // null where this band is the only one
    for (int w = t; w < nb; w += kThreads) removed_g[w] = removed[w];
  clk.mark(kFinish);
  clk.save(t);
}

__global__ void empty_kernel() {}

template <bool kLarge>
int launch(const void* diag, const void* nxt, const void* pairs, const void* start,
           long long base, void* removed, void* keep, int batch, int n, int r0, int r1,
           void* stream) {
  const int nb = (n + kBlock - 1) / kBlock;
  const size_t smem = kStages * sizeof(Stage<kLarge ? kCapLarge : kCapSmall>) +
                      nb * sizeof(unsigned long long) +
                      (kLarge ? 0 : 2 * (r1 - r0) * sizeof(int));
  static int smem_allowed[64] = {};  // per device: the kernel's shared memory limit as set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 64 || static_cast<int>(smem) > smem_allowed[dev])) {
    err = cudaFuncSetAttribute(nms_resolve_kernel<kLarge>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess && dev < 64) smem_allowed[dev] = static_cast<int>(smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_resolve_kernel<kLarge><<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(diag), static_cast<const unsigned long long*>(nxt),
      static_cast<const Pair*>(pairs), static_cast<const long long*>(start), base,
      static_cast<unsigned long long*>(removed), static_cast<uint8_t*>(keep), n, nb, r0, r1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch (0 = success).
// `start` null: the slots layout (one band of all row blocks). `removed` may be
// null where this band is the only one. `large` not 0: the variant for large
// images, which are packed (`start` not null).
extern "C" int cdt_nms_resolve(const void* diag, const void* nxt, const void* pairs,
                               const void* start, long long base, void* removed, void* keep,
                               int batch, int n, int r0, int r1, int large, void* stream) {
  if (batch <= 0 || n <= 0 || r1 <= r0) return 0;
  if (large && !start) return static_cast<int>(cudaErrorInvalidValue);
  return large ? launch<true>(diag, nxt, pairs, start, base, removed, keep, batch, n, r0, r1, stream)
               : launch<false>(diag, nxt, pairs, start, base, removed, keep, batch, n, r0, r1,
                               stream);
}

// An empty kernel on `stream`: the floor under any launch, for measurements.
extern "C" int cdt_empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

#ifdef CDT_NMS_TRACE
// The instrumented build's readings of its last launch (see phase_cycles):
// 2 * (kPhases + 1) int64 copied to host memory at `out`.
extern "C" int cdt_nms_resolve_phases(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles)));
}
#endif

extern "C" const char* cdt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
