// Suppression bits of greedy NMS, for Hopper (sm_90a): the parallel half of
// the sweep. The sequential half is nms_resolve.cu.
//
// Replaces, with nms_resolve.cu: celldetection_tpu/kernels/nms_pallas.py:
// _nms_kernel (the Pallas TPU kernel that nms_pallas_impl launches). That
// kernel builds the same relation tile by tile inside its sequential grid;
// here it is built for all pairs at once, across the whole card.
//
// What it computes. Boxes [B, n, 4] f32 are sorted by descending score per
// image, valid [B, n] bool. The boxes are cut into blocks of 64. For row i and
// column block c, word (i, c) has bit l set iff column j = 64c + l comes after
// i (j > i, j < n), rows i and j are both valid, and i suppresses j:
// `inter > thresh * union` with `union = (area_i + area_j) - inter`, exactly as
// ops/boxes.py:_suppression_matrix rounds it (built with -fmad=false and the
// _rn intrinsics below, so no FMA forms; min/max propagate NaN as torch does).
// Invalid rows suppress nothing and invalid columns are never suppressed (an
// invalid box is never kept, so its bits would change no keep mask).
//
// Two kernels share the tests, in one of two layouts. Rows are numbered
// block-major, row q = (r * B + b) * 64 + l for row l of block r of image b,
// so that the rows of a band of row blocks are consecutive for all images.
//   - nms_bits_count writes, for each box j, the word of the earlier boxes of
//     its own block that suppress it, with j's own bit set iff j is valid (the
//     diagonal block's column words, which the resolve's parallel greedy
//     reads), into diag [B, nb * 64] u64 (0 past n). For the packed layout it
//     also writes each row's word of the next block into nxt [B, nb * 64],
//     the number of its later words that are not zero into start [1 + q]
//     (i64), and flags, set where row block r has a word in column block c
//     that is not zero: [B, nb, nb] u8 or, for large images (`large`, more
//     than 4,096 blocks: kernels/nms.py:large_layout), one bit per block
//     pair, bit c % 32 of u32 word [B, nb, ceil(nb / 32)] c / 32 (32 MiB at
//     n = 2^20 where bytes would take 256 MiB); the launch zeroes start and
//     flags first, and an exclusive prefix sum over start in place (the
//     wrapper's torch.cumsum) makes start [q] the offset of row q's first pair;
//   - nms_bits_fill writes the later words that are not zero as Pair {bits,
//     row = b * n + i, word = c} (nms_common.cuh). Packed, for the rows of a
//     band of row blocks, it tests again only the column blocks that flags
//     marks and writes at offsets from a copy of start (less the band's first
//     offset, `base`), in no fixed order inside a row. In slots (images of at
//     most 2,048 boxes, see nms_common.cuh: slot_of), every later word has a
//     fixed slot, zero where the word is zero; the count then does the
//     diagonal blocks only and the fill every later test, so each test runs
//     once and nothing waits on the host or a prefix sum.
//
// What bounds it on this card: operations. An image of n boxes needs about
// n^2 / 2 pair tests of 14 fp32 operations each (3.4e10 tests at
// n = 262,144), and reads only 17 bytes per box. Tensor cores have no part
// in it: a pair test is min/max, subtract, multiply and compare, not a
// product.
//
// What the design does about it:
//   - the grid is (column band, row block, image): every (row block, band of
//     1 to 8 column blocks) pair of an image is a CTA of 64 threads, so even
//     one image spreads over all 132 SMs. The band is the narrowest that keeps
//     the grid within a few waves of the card: narrow bands give small images
//     many short CTAs, wide ones spare large images CTA overhead;
//   - a thread owns one row and keeps its box and area in registers; the
//     band's column boxes are staged in shared memory (at most 8 KB) by
//     cp.async, all blocks in flight at once, and read as broadcasts. A ring
//     of two buffers is not needed: the whole band fits, and the other CTAs
//     resident on the SM hide the one wait;
//   - where every staged box is finite with an area >= 0 and thresh >= 0
//     (checked per CTA, the case of all real detections), min and max are
//     single instructions and a pair whose boxes are apart on an axis skips
//     the rest of its test, which at stitch scale is almost every pair; the
//     NaN-propagating full test runs only where needed;
//   - a CTA whose rows, or a column block whose boxes, are all invalid skips
//     its tests (the invalid boxes sort last); the packed fill skips every
//     column block without a word that is not zero, which at stitch scale is
//     almost all of them: a box overlaps a few neighbours only;
//   - packed, only the words that are not zero are stored.
//
// Scratch bound: diag 8 B per box (the boxes padded to a multiple of 64) and,
// slots, B * 64 * nb * (nb - 1) / 2 pairs of 16 B (2 MiB at B = 4, n = 2048).
// Packed: nxt, start and the fill's copy of it 8 B per box each, flags
// B * (n / 64)^2 bytes (16 MiB at n = 262,144), or an eighth of that for large
// images (32 MiB at n = 2^20, the wrapper's largest), and the pairs, 16 B
// each. The wrapper (kernels/nms.py) sizes the pairs from the
// counts and walks the row blocks in bands of at most PAIR_BUDGET pairs
// (128 MiB), or one row block's pairs where that is more; where even every
// later word of every row would fit in PAIR_BUDGET, it allocates that bound
// and reads no count on the host.
#include <cuda_runtime.h>
#include <stdint.h>

#include "nms_common.cuh"

namespace {

using cdt_nms::kBlock;
using cdt_nms::Pair;
using cdt_nms::slot_of;

constexpr int kBand = 8;      // column blocks per CTA at most
constexpr int kThreads = 64;  // one thread per row of the row block
constexpr int kFullGrid = 132 * 64;  // CTAs that fill the card a few times over

// torch.maximum / torch.minimum semantics: a NaN operand gives NaN.
__device__ __forceinline__ float max_nan(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float min_nan(float a, float b) { return (a != a || a < b) ? a : b; }

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IoU(r, c) > thresh in the multiply form of _suppression_matrix. kFast:
// every coordinate is finite, so no operand of a min or max below is NaN and
// they may be the single instructions fminf/fmaxf; those differ from the
// NaN-propagating forms only in the sign of a zero, which changes no
// comparison below.
template <bool kFast>
__device__ __forceinline__ bool suppresses(float4 r, float ar, float4 c, float ac, float thresh) {
  float iw, ih;
  if (kFast) {
    iw = fmaxf(__fsub_rn(fminf(r.z, c.z), fmaxf(r.x, c.x)), 0.f);
    ih = fmaxf(__fsub_rn(fminf(r.w, c.w), fmaxf(r.y, c.y)), 0.f);
  } else {
    iw = max_nan(__fsub_rn(min_nan(r.z, c.z), max_nan(r.x, c.x)), 0.f);
    ih = max_nan(__fsub_rn(min_nan(r.w, c.w), max_nan(r.y, c.y)), 0.f);
  }
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(ar, ac), inter);
  return (uni > 0.f ? inter : 0.f) > __fmul_rn(thresh, uni);
}

// Two boxes whose intervals do not overlap on an axis (touching counts as
// apart) have inter = 0. Where every area is >= 0 and thresh >= 0 (kFast),
// union >= 0 then, and `0 > thresh * union` is false: no suppression, as the
// full test would find. At stitch scale almost every pair is such, and a warp
// whose 32 pairs all are skips the rest of the test.
__device__ __forceinline__ bool apart(float4 r, float4 c) {
  return c.x >= r.z || r.x >= c.z || c.y >= r.w || r.y >= c.w;
}

// Bit l: box `me` suppresses column l of the staged block (as_row) or column
// l suppresses `me` (!as_row), over all 64 columns.
template <bool kFast>
__device__ __forceinline__ unsigned long long word_of(float4 me, float am, const float4* cols,
                                                      const float* areas, float thresh,
                                                      bool as_row) {
  unsigned long long w = 0ull;
#pragma unroll 16
  for (int l = 0; l < kBlock; ++l) {
    const float4 c = cols[l];
    if (kFast && apart(me, c)) continue;
    if (as_row ? suppresses<kFast>(me, am, c, areas[l], thresh)
               : suppresses<kFast>(c, areas[l], me, am, thresh))
      w |= 1ull << l;
  }
  return w;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool in) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = in ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

// The box keeps the fast test exact: finite corners and an area >= 0.
__device__ __forceinline__ bool tame(float4 b, float area) {
  return isfinite(b.x) && isfinite(b.y) && isfinite(b.z) && isfinite(b.w) && area >= 0.f;
}

// One CTA: row block r = r0 + blockIdx.y of image blockIdx.z against the
// column blocks of band r / band + blockIdx.x (band column blocks each) that
// are not before r. Where that band holds r itself, its first block is the
// diagonal one: the count kernel stores its column words, thread t for column
// t (the rows before t in the block that suppress t), and no pair. The
// layout is packed where the count has `counts` and the fill a `cursor`,
// slots otherwise; in slots the count does the diagonal blocks only. kLarge:
// the flags are bits (a separate build of the kernel, so that images of up to
// 262,144 boxes run the code they ran before the bits existed).
template <bool kFill, bool kLarge>
__global__ void __launch_bounds__(kThreads)
nms_bits_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid, int n,
                int nb, int band, float thresh, int r0, unsigned long long* __restrict__ counts,
                unsigned long long* __restrict__ diag, unsigned long long* __restrict__ nxt,
                uint8_t* __restrict__ flags, unsigned long long* __restrict__ cursor,
                Pair* __restrict__ pairs, long long base) {
  __shared__ __align__(16) float4 cols[kBand][kBlock];
  __shared__ float careas[kBand][kBlock];
  __shared__ unsigned cvalid[kBand][2];  // valid bits of each column block, two halves

  const int b = blockIdx.z;
  const int r = r0 + blockIdx.y;
  const int g = r / band + blockIdx.x;
  const int c_begin = max(r, g * band);
  const int c_end = min(nb, (g + 1) * band);
  if (c_begin >= c_end) return;  // past the last column block: the whole CTA
  const int nc = c_end - c_begin;
  const bool has_diag = c_begin == r;
  const int t = threadIdx.x;
  const int i = r * kBlock + t;
  const size_t img = static_cast<size_t>(b) * n;
  const size_t row = static_cast<size_t>(b) * nb * kBlock + i;  // in diag and nxt, [B, nb * 64]
  const size_t q = (static_cast<size_t>(r) * gridDim.z + b) * kBlock + t;  // block-major row
  const bool packed = kFill ? cursor != nullptr : counts != nullptr;
  // some word of row block r in column block c is not zero: byte
  // flags[(b * nb + r) * nb + c] or, large, bit c % 32 of u32 word
  // (b * nb + r) * ceil(nb / 32) + c / 32
  const size_t flag_row = static_cast<size_t>(b) * nb + r;
  uint8_t* const flag = packed && !kLarge ? flags + flag_row * nb + c_begin : nullptr;
  unsigned* const flag_bits =
      packed && kLarge ? reinterpret_cast<unsigned*>(flags) + flag_row * ((nb + 31) / 32) : nullptr;
  auto flagged = [&](int k) {
    const int c = c_begin + k;
    if constexpr (kLarge) return ((flag_bits[c >> 5] >> (c & 31)) & 1u) != 0u;
    return flag[k] != 0;
  };
  // the column block after r: each row's word there goes to nxt (count,
  // packed); the last row block's rows have none, and the diagonal CTA
  // writes their 0
  const int k_next = r + 1 - c_begin;
  const bool has_next = !kFill && packed && k_next >= 0 && k_next < nc;
  const bool no_next = !kFill && packed && has_diag && r == nb - 1;

  const bool row_in = i < n && valid[img + i];
  if (!__syncthreads_or(row_in)) {  // no valid row: every word is zero
    if (!kFill && has_diag) diag[row] = 0ull;
    if (has_next || no_next) nxt[row] = 0ull;
    return;
  }
  unsigned todo = 0u;  // bit k: column block c_begin + k needs its tests
#pragma unroll
  for (int k = 0; k < kBand; ++k) {
    const bool diagonal = k == 0 && has_diag;
    if (k < nc && (kFill ? !diagonal && (!packed || flagged(k)) : packed || diagonal))
      todo |= 1u << k;
  }
  if (!todo) return;  // uniform: the fill finds only zero words here
  const float4 rb = row_in ? boxes[img + i] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float ra = area_of(rb);

  // stage the band's columns: thread t copies column 64c + t of each block
#pragma unroll
  for (int k = 0; k < kBand; ++k) {
    const int j = (c_begin + k) * kBlock + t;
    if ((todo >> k) & 1u) cp_async16(&cols[k][t], boxes + img + (j < n ? j : 0), j < n);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  bool col_in[kBand];
#pragma unroll
  for (int k = 0; k < kBand; ++k) {
    const int j = (c_begin + k) * kBlock + t;
    col_in[k] = ((todo >> k) & 1u) && j < n && valid[img + j];
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  bool wild = !tame(rb, ra);
#pragma unroll
  for (int k = 0; k < kBand; ++k) {
    if ((todo >> k) & 1u) {  // uniform
      careas[k][t] = area_of(cols[k][t]);
      wild |= !tame(cols[k][t], careas[k][t]);
      const unsigned half = __ballot_sync(0xffffffffu, col_in[k]);
      if ((t & 31) == 0) cvalid[k][t >> 5] = half;
    }
  }
  const bool fast = !__syncthreads_or(wild) && thresh >= 0.f;

  unsigned long long words[kBand];
#pragma unroll
  for (int k = 0; k < kBand; ++k) {
    unsigned long long w = 0ull;
    if ((todo >> k) & 1u) {
      const bool diagonal = k == 0 && has_diag;
      const unsigned long long cv =
          (static_cast<unsigned long long>(cvalid[k][1]) << 32) | cvalid[k][0];
      if (row_in && cv) {
        w = fast ? word_of<true>(rb, ra, cols[k], careas[k], thresh, !diagonal)
                 : word_of<false>(rb, ra, cols[k], careas[k], thresh, !diagonal);
        w &= cv;
        if (diagonal) w &= (1ull << t) - 1ull;  // column t: the rows before it
      }
    }
    words[k] = w;
  }

  const int first = has_diag ? 1 : 0;  // the words stored as pairs
  int nz = 0;
#pragma unroll
  for (int k = 0; k < kBand; ++k) nz += (k >= first && words[k] != 0ull) ? 1 : 0;
  if (!kFill) {  // rows past n too: their words are 0
    if (has_diag) diag[row] = words[0] | (row_in ? 1ull << t : 0ull);  // own bit: valid
    if (!packed) return;
    if (no_next) nxt[row] = 0ull;
    unsigned marked = 0u;  // bit k: column block c_begin + k holds a word of this row
#pragma unroll
    for (int k = 0; k < kBand; ++k) {
      if (k >= first && words[k] != 0ull) {
        if constexpr (kLarge)
          marked |= 1u << k;
        else
          flag[k] = 1;  // the same byte from many threads
      }
      if (has_next && k == k_next) nxt[row] = words[k];
    }
    if constexpr (kLarge) {  // one atomicOr per marked block from each warp
      marked = __reduce_or_sync(0xffffffffu, marked);
      if ((t & 31) == 0)
        for (int k = 0; k < kBand; ++k)
          if ((marked >> k) & 1u) {
            const int c = c_begin + k;
            atomicOr(flag_bits + (c >> 5), 1u << (c & 31));
          }
    }
    if (nz) atomicAdd(counts + q, static_cast<unsigned long long>(nz));
    return;
  }
  if (i >= n || !nz) return;
  // packed: the row's next free offsets; slots: a fixed slot per word
  size_t pos = cursor ? atomicAdd(cursor + q, static_cast<unsigned long long>(nz)) - base
                      : slot_of(r, b, gridDim.z, nb) + static_cast<size_t>(t) * (nb - 1 - r)
                            + (c_begin - r - 1);
#pragma unroll
  for (int k = 0; k < kBand; ++k) {
    if (k >= first && words[k] != 0ull) {
      Pair p;
      p.bits = words[k];
      p.row = static_cast<int>(img + i);
      p.word = c_begin + k;
      pairs[cursor ? pos++ : pos + k] = p;
    }
  }
}

// Column blocks per CTA: the fewest (so the most CTAs, with the least serial
// work each) that keep the grid within a few waves of the card.
int band_of(int batch, int nb) {
  int band = 1;
  while (band < kBand &&
         static_cast<long long>(batch) * nb * ((nb + band - 1) / band) / 2 > kFullGrid)
    band *= 2;
  return band;
}

template <bool kLarge>
int launch(bool fill, const void* boxes, const void* valid, int batch, int n, float thresh,
           int r0, int r1, unsigned long long* counts, unsigned long long* diag,
           unsigned long long* nxt, uint8_t* flags, unsigned long long* cursor, Pair* pairs,
           long long base, void* stream) {
  if (batch <= 0 || n <= 0 || r1 <= r0) return 0;
  const int nb = (n + kBlock - 1) / kBlock;
  const int band = band_of(batch, nb);
  // the count in slots does the diagonal blocks only: the first band of each row block
  const int bands = !fill && !counts ? 1 : (nb + band - 1) / band - r0 / band;
  const dim3 grid(bands, r1 - r0, batch);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* bx = static_cast<const float4*>(boxes);
  const auto* v = static_cast<const uint8_t*>(valid);
  if (fill)
    nms_bits_kernel<true, kLarge><<<grid, kThreads, 0, s>>>(
        bx, v, n, nb, band, thresh, r0, counts, diag, nxt, flags, cursor, pairs, base);
  else
    nms_bits_kernel<false, kLarge><<<grid, kThreads, 0, s>>>(
        bx, v, n, nb, band, thresh, r0, counts, diag, nxt, flags, cursor, pairs, base);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launches on `stream` and returns the CUDA error of the launch (0 =
// success). Packed: `start` has nb * batch * 64 + 1 entries, `nxt` batch * n
// and `flags` batch * nb * nb bytes, or batch * nb * ceil(nb / 32) u32 words
// where `large` is not 0; slots: all three are null and only `diag` is
// written.
extern "C" int cdt_nms_bits_count(const void* boxes, const void* valid, void* start, void* diag,
                                  void* nxt, void* flags, int batch, int n, float thresh,
                                  int large, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int nb = (n + kBlock - 1) / kBlock;
  auto* counts = static_cast<unsigned long long*>(start);
  if (counts) {
    const size_t rows = static_cast<size_t>(nb) * batch * kBlock;
    const size_t flag_bytes = static_cast<size_t>(batch) * nb *
                              (large ? (nb + 31) / 32 * sizeof(unsigned) : nb);
    const auto s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(flags, 0, flag_bytes, s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(counts, 0, (rows + 1) * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto* const d = static_cast<unsigned long long*>(diag);
  auto* const x = static_cast<unsigned long long*>(nxt);
  auto* const f = static_cast<uint8_t*>(flags);
  auto* const c = counts ? counts + 1 : nullptr;
  return large ? launch<true>(false, boxes, valid, batch, n, thresh, 0, nb, c, d, x, f, nullptr,
                              nullptr, 0, stream)
               : launch<false>(false, boxes, valid, batch, n, thresh, 0, nb, c, d, x, f, nullptr,
                               nullptr, 0, stream);
}

// Packed: `cursor` is a copy of the prefix-summed `start`, `base` =
// start[r0 * batch * 64], `flags` and `large` as the count's. Slots (`cursor`
// null, one band of all row blocks): `pairs` has slot_of(nb - 1, 0, batch, nb)
// entries, zeroed here first.
extern "C" int cdt_nms_bits_fill(const void* boxes, const void* valid, const void* flags,
                                 void* cursor, void* pairs, int batch, int n, float thresh, int r0,
                                 int r1, long long base, int large, void* stream) {
  if (!cursor && batch > 0 && n > 0) {
    const int nb = (n + kBlock - 1) / kBlock;
    const cudaError_t err = cudaMemsetAsync(pairs, 0, slot_of(nb - 1, 0, batch, nb) * sizeof(Pair),
                                            static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto* const f = static_cast<uint8_t*>(const_cast<void*>(flags));
  auto* const c = static_cast<unsigned long long*>(cursor);
  auto* const p = static_cast<Pair*>(pairs);
  return large ? launch<true>(true, boxes, valid, batch, n, thresh, r0, r1, nullptr, nullptr,
                              nullptr, f, c, p, base, stream)
               : launch<false>(true, boxes, valid, batch, n, thresh, r0, r1, nullptr, nullptr,
                               nullptr, f, c, p, base, stream);
}

extern "C" const char* cdt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
