// Exact greedy NMS sweep over score-sorted boxes, for Hopper (sm_90a).
//
// Replaces: celldetection_tpu/kernels/nms_pallas.py:_nms_kernel (the Pallas
// TPU kernel that nms_pallas_impl launches). Contract of the plain version
// celldetection_tpu_torch/ops/boxes.py:_nms_sweep: boxes [B, N, 4] f32 sorted
// by descending score per image, valid [B, N] bool; out keep [B, N] bool in
// the same sorted order. Box i is kept iff it is valid and no kept box before
// it overlaps it with IoU > thresh, tested as `inter > thresh * union` with
// `union = (area_r + area_c) - inter`, exactly as the plain version rounds it
// (built with -fmad=false, and the _rn intrinsics below, so no FMA forms).
//
// What bounds it on this card: neither bytes (17 B per box in, 1 B out) nor
// arithmetic (~14 fp32 operations per pair test; N = 2048 needs at most ~2M
// tests, well under a microsecond of the card's fp32 rate). The bound is
// the greedy dependency chain: whether box j is kept depends on every kept
// box before it, so the work is a sequence, not a map.
//
// What the design does about it (simple and exact first):
//   - one CTA per image; all images in one launch;
//   - the image's boxes are walked in tiles of 256; a tile is staged in
//     shared memory and its 256 x 256 "row r suppresses later column j"
//     relation is built by all threads as a bit matrix (8 KB);
//   - one warp then runs the sequential in-tile greedy over the bit matrix,
//     lane w < 8 owning columns [32w, 32w + 32); it visits kept rows only
//     (find-first-set over the live keep word), so a step is one shared
//     load, one AND and one shuffle;
//   - all threads then clear every later box that is still alive against
//     the tile's kept rows (compacted into a list), stopping at the first
//     suppressor;
//   - the keep mask lives in global memory and nothing O(N^2) is stored, so
//     the same kernel serves N = 262,144 at stitch scale.
// Left for later: more than one CTA per image (a 4-image batch fills 4 of
// the 132 SMs) and a parallel clearing pass across CTAs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;                 // boxes per greedy tile
constexpr int kWords = kTile / 32;         // 32-bit words per bit-matrix row
constexpr int kThreads = 1024;             // threads per CTA

// torch.maximum / torch.minimum semantics: a NaN operand gives NaN.
__device__ __forceinline__ float max_nan(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float min_nan(float a, float b) { return (a != a || a < b) ? a : b; }

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IoU(r, c) > thresh in the multiply form of _suppression_matrix.
__device__ __forceinline__ bool suppresses(float4 r, float ar, float4 c, float ac, float thresh) {
  const float iw = max_nan(__fsub_rn(min_nan(r.z, c.z), max_nan(r.x, c.x)), 0.f);
  const float ih = max_nan(__fsub_rn(min_nan(r.w, c.w), max_nan(r.y, c.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(ar, ac), inter);
  return (uni > 0.f ? inter : 0.f) > __fmul_rn(thresh, uni);
}

__global__ void __launch_bounds__(kThreads)
nms_sweep_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
                 uint8_t* __restrict__ keep, int n, float thresh) {
  __shared__ float4 rows[kTile];
  __shared__ float areas[kTile];
  __shared__ uint32_t sup[kTile][kWords];  // bit (j & 31) of sup[r][j >> 5]: r suppresses j > r
  __shared__ uint32_t alive[kWords];       // the tile's live keep bits
  __shared__ int kept_rows[kTile];
  __shared__ int num_kept;

  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  boxes += base;
  valid += base;
  keep += base;
  const int t = threadIdx.x;

  for (int i = t; i < n; i += kThreads) keep[i] = valid[i] ? 1 : 0;
  __syncthreads();

  for (int s = 0; s < n; s += kTile) {
    const int len = min(kTile, n - s);

    // 1. stage the tile and its live bits (warps 0-7, whole warps only)
    if (t < kTile) {
      const bool in = t < len;
      const float4 r = in ? boxes[s + t] : make_float4(0.f, 0.f, 0.f, 0.f);
      rows[t] = r;
      areas[t] = area_of(r);
      const unsigned live = __ballot_sync(0xffffffffu, in && keep[s + t]);
      if ((t & 31) == 0) alive[t >> 5] = live;
    }
    __syncthreads();

    // 2. bit matrix; a warp covers 32 rows of one word, so rows[j] is a
    //    broadcast read. Rows dead before the tile never suppress.
    for (int e = t; e < kTile * kWords; e += kThreads) {
      const int r = e % kTile;
      const int j0 = (e / kTile) * 32;
      uint32_t bits = 0u;
      if (j0 + 31 > r && ((alive[r >> 5] >> (r & 31)) & 1u)) {
        const float4 br = rows[r];
        const float ar = areas[r];
        for (int l = 0; l < 32; ++l) {
          const int j = j0 + l;
          if (j > r && j < len && suppresses(br, ar, rows[j], areas[j], thresh)) bits |= 1u << l;
        }
      }
      sup[r][e / kTile] = bits;
    }
    __syncthreads();

    // 3. sequential in-tile greedy on one warp; visit live rows in order
    if (t < 32) {
      uint32_t kw = t < kWords ? alive[t] : 0u;
      for (int w = 0; w < kWords; ++w) {
        uint32_t todo = __shfl_sync(0xffffffffu, kw, w);
        while (todo) {
          const int l = __ffs(todo) - 1;
          if (t < kWords) kw &= ~sup[w * 32 + l][t];
          // live bits of word w above l (2u << 31 wraps to 0: none left)
          todo = __shfl_sync(0xffffffffu, kw, w) & ~((2u << l) - 1u);
        }
      }
      if (t < kWords) alive[t] = kw;
    }
    __syncthreads();

    // 4. write the tile's keep and compact its kept rows, in order
    if (t < kTile) {
      const uint32_t word = alive[t >> 5];
      const bool k = (word >> (t & 31)) & 1u;
      if (t < len) keep[s + t] = k ? 1 : 0;
      if (k) {
        int pos = __popc(word & ((1u << (t & 31)) - 1u));
        for (int w = 0; w < (t >> 5); ++w) pos += __popc(alive[w]);
        kept_rows[pos] = t;
      }
    }
    if (t == 0) {
      int c = 0;
      for (int w = 0; w < kWords; ++w) c += __popc(alive[w]);
      num_kept = c;
    }
    __syncthreads();

    // 5. clear later boxes still alive that a kept row of the tile overlaps
    const int nk = num_kept;
    for (int c = s + kTile + t; nk > 0 && c < n; c += kThreads) {
      if (!keep[c]) continue;
      const float4 bc = boxes[c];
      const float ac = area_of(bc);
      for (int q = 0; q < nk; ++q) {
        const int r = kept_rows[q];
        if (suppresses(rows[r], areas[r], bc, ac, thresh)) {
          keep[c] = 0;
          break;
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch (0 = success).
extern "C" int cdt_nms_sweep(const void* boxes, const void* valid, void* keep, int batch,
                             int n, float thresh, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  nms_sweep_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), n, thresh);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cdt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
