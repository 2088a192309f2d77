// The CPN heads' first K x K convolution in bf16, for Hopper (sm_90a): a
// stride-1, zero-padded ("same", padding K / 2) 2-D convolution as an
// implicit GEMM on the tensor cores (wgmma), fed by the Tensor Memory
// Accelerator (TMA).
//
// Replaces no TPU kernel: the JAX package leaves this convolution to XLA
// (celldetection_tpu/models/commons.py: fused_head_conv). It was added
// because cuDNN's heuristic runs it without tensor cores in bf16, at about
// 36 TFLOP/s, 86% of the flagship CpnResNeXt101UNet's step on 1024^2 tiles.
//
// What it computes. Input x [B, H, W, Cin] bf16 (NHWC: channels-last
// [B, Cin, H, W]), weights w [Cout, K, K, Cin] bf16 (laid out once a call by
// the wrapper, kernels/head_conv.py), bias [Cout] fp32; output
// out [B, H, W, Cout] bf16:
//   out[b, y, x, n] = bf16_rn(bias[n] + sum_{kh, kw, c} x[b, y + kh - P, x + kw - P, c]
//                                                     * w[n, kh, kw, c])
// with P = K / 2 and x zero outside the image. The products of bf16 values
// are exact in fp32 and summed in fp32 by wgmma; the bias is added in fp32
// and the sum rounded once to bf16. As a GEMM: rows are the B*H*W output
// pixels, columns the Cout output channels, depth the K*K taps x Cin input
// channels. Takes Cin and Cout multiples of 64, any odd K, any B, H, W.
//
// What bounds it on this card: operations. The flagship's fused heads,
// x [4, 512, 512, 256] by w [768, 7, 7, 256], need 2 * 4 * 512^2 * 768 *
// 12,544 = 20.2 TFLOP, 20.4 ms at the 989 TFLOP/s dense bf16 peak, against
// 0.5 GB of input, weights and output at least: about 1,500 FLOP a byte of
// device memory, far above the card's ridge (about 295). The same holds for
// every head shape the port runs (U22: 128 -> 384 channels; the refinement
// head's 64 -> 64 at full resolution).
//
// What the design does about it:
//   - every multiply runs on wgmma (m64 n BN k16, bf16 in, fp32 accumulator
//     in registers): the only way to the tensor cores' full rate;
//   - a block owns a tile of 128 output pixels, 8 rows x 16 columns of one
//     image, and BN output channels (256 where Cout allows, else 128 or 64):
//     128 x 256 x 64 per stage is 85 FLOP per byte staged, which the L2
//     feeds;
//   - one producer thread walks the depth as (tap, 64 channels) steps and
//     issues two TMA loads a step: the input box {64 channels, 16 columns,
//     8 rows, 1 image} of a 4-D tensor map over the NHWC input, at
//     (y0 + kh - P, x0 + kw - P), and the weights' box {64, BN} of a 2-D map
//     over [Cout, K*K*Cin]. TMA fills the box's elements outside the image
//     with zeros: that is exactly the convolution's zero padding, with no
//     masks, no halo copies and no index math in the multiplying warps;
//     ragged tiles at the right and bottom borders load zeros the same way
//     and are masked only at the store;
//   - both maps use the 128-byte swizzle, the layout wgmma reads without
//     bank conflicts (each row of a box is 64 bf16 = 128 bytes);
//   - a ring of stages (4 x 48 KiB at BN = 256, 6 at 128, 8 at 64) guarded
//     by mbarriers: "full" completes on the TMA's bytes, "empty" on one
//     arrival from each multiplying warpgroup once its wgmma of that stage
//     has retired; each warpgroup keeps one step of wgmma in flight while it
//     waits for the next stage;
//   - two consumer warpgroups, each 64 of the 128 rows against all BN
//     columns; the producer warpgroup gives up registers (setmaxnreg) to
//     them;
//   - persistent blocks, one per SM, walk the tiles in order with the
//     output-channel slices innermost, so the slices of one pixel tile run
//     at the same time and its input halo is read from L2; the producer
//     runs ahead into the next tile while the consumers store the last one;
//   - the epilogue adds the bias to the fp32 accumulators in registers,
//     rounds once to bf16 and stores pairs of channels straight to the
//     NHWC output;
//   - nothing is tuned at run time: the tile shape is fixed and BN follows
//     from Cout.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kTileH = 8, kTileW = 16;
constexpr int kBM = kTileH * kTileW;           // output pixels a tile
constexpr int kBK = 64;                        // depth a stage: 64 channels of one tap
constexpr int kThreads = 384;                  // warpgroup 0 loads; 1 and 2 multiply
constexpr int kStageBytesA = kBM * kBK * 2;    // 16 KiB
constexpr int kSmemBudget = 192 * 1024;        // for the ring of stages
constexpr int kEncodeError = 10000;            // + CUresult of cuTensorMapEncodeTiled

template <int BN>
struct Cfg {
  static constexpr int kStageBytesB = BN * kBK * 2;
  static constexpr int kStageBytes = kStageBytesA + kStageBytesB;
  static constexpr int kStages = kSmemBudget / kStageBytes;    // 4, 6 or 8
  // the ring, its barriers, and room to align the ring to 1024 bytes (the
  // 128-byte swizzle's period)
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma's shared-memory matrix descriptor of a K-major tile in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart. Adding 2 to it
// moves the start 32 bytes on, to the next 16 of the 64 channels.
__device__ __forceinline__ uint64_t make_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_operands(float* acc) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// D[64 x N] += A[64 x 16] * B[N x 16]^T, both K-major in shared memory; each
// of the warpgroup's threads holds N / 2 fp32 values of D.
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_step(float* d, uint64_t desc_a, uint64_t desc_b) {
  if constexpr (BN == 256) wgmma_n256(d, desc_a, desc_b);
  else if constexpr (BN == 128) wgmma_n128(d, desc_a, desc_b);
  else wgmma_n64(d, desc_a, desc_b);
}

struct Tile {
  int b, y0, x0, n0;
};

// Tile t of the walk: output-channel slices innermost, then 16-column and
// 8-row blocks of each image.
__device__ __forceinline__ Tile tile_of(int t, int tiles_n, int tiles_x, int tiles_y, int bn) {
  Tile tile;
  tile.n0 = (t % tiles_n) * bn;
  t /= tiles_n;
  tile.x0 = (t % tiles_x) * kTileW;
  t /= tiles_x;
  tile.y0 = (t % tiles_y) * kTileH;
  tile.b = t / tiles_y;
  return tile;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    head_conv_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w, const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int batch, int height, int width, int cin,
                     int cout, int ksize) {
  using C = Cfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring_a = smem;                                   // kStages x [128 pixels][64 channels]
  uint8_t* ring_b = smem + C::kStages * kStageBytesA;       // kStages x [BN][64 channels]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_b + C::kStages * C::kStageBytesB);
  uint64_t* empty = full + C::kStages;

  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int tiles_y = (height + kTileH - 1) / kTileH;
  const int tiles_n = cout / BN;
  const int tiles = batch * tiles_y * tiles_x * tiles_n;
  const int chunks = cin / kBK;
  const int steps = ksize * ksize * chunks;
  const int pad = ksize / 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // the producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tile = tile_of(t, tiles_n, tiles_x, tiles_y, BN);
        for (int step = 0; step < steps; ++step) {
          const int chunk = step % chunks, tap = step / chunks;
          const int kh = tap / ksize, kw = tap % ksize;
          mbar_wait(smem_u32(empty + stage), phase ^ 1);
          const uint32_t bar = smem_u32(full + stage);
          mbar_expect_tx(bar, C::kStageBytes);
          tma_load_4d(smem_u32(ring_a + stage * kStageBytesA), &map_x, bar, chunk * kBK,
                      tile.x0 + kw - pad, tile.y0 + kh - pad, tile.b);
          tma_load_2d(smem_u32(ring_b + stage * C::kStageBytesB), &map_w, bar, step * kBK,
                      tile.n0);
          if (++stage == C::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // the consumers: warpgroup g multiplies rows 64g..64g+63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int g = wg - 1, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    int stage = 0;
    uint32_t phase = 0;
    float acc[BN / 2];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tile = tile_of(t, tiles_n, tiles_x, tiles_y, BN);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int step = 0; step < steps; ++step) {
        mbar_wait(smem_u32(full + stage), phase);
        __syncwarp();   // the wgmma instructions below are warp-aligned
        const uint64_t desc_a = make_desc(ring_a + stage * kStageBytesA + g * 64 * kBK * 2);
        const uint64_t desc_b = make_desc(ring_b + stage * C::kStageBytesB);
        fence_operands<BN / 2>(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / 16; ++k) wgmma_step<BN>(acc, desc_a + 2 * k, desc_b + 2 * k);
        wgmma_commit();
        fence_operands<BN / 2>(acc);
        // the step before this one has retired: its stage goes back to the producer
        wgmma_wait<1>();
        if (prev >= 0 && tid == 0) mbar_arrive(smem_u32(empty + prev));
        prev = stage;
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operands<BN / 2>(acc);
      if (tid == 0) mbar_arrive(smem_u32(empty + prev));

      // epilogue: thread (warp, lane) holds rows warp * 16 + lane / 4 (+ 8)
      // of its 64, columns 8j + 2 (lane % 4) (+ 1) for each j
      const int col = tile.n0 + 2 * (lane % 4);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = g * 64 + warp * 16 + lane / 4 + 8 * r;
        const int y = tile.y0 + m / kTileW, x = tile.x0 + m % kTileW;
        if (y < height && x < width) {
          __nv_bfloat16* row =
              out + ((static_cast<size_t>(tile.b) * height + y) * width + x) * cout + col;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const float2 bb = *reinterpret_cast<const float2*>(bias + col + 8 * j);
            *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
                __floats2bfloat162_rn(acc[4 * j + 2 * r] + bb.x, acc[4 * j + 2 * r + 1] + bb.y);
          }
        }
      }
    }
  }
}

template <int BN>
int launch(const CUtensorMap& map_x, const CUtensorMap& map_w, const float* bias,
           __nv_bfloat16* out, int batch, int height, int width, int cin, int cout, int ksize,
           cudaStream_t stream) {
  using C = Cfg<BN>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(head_conv_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>(batch) * ((height + kTileH - 1) / kTileH) *
                          ((width + kTileW - 1) / kTileW) * (cout / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  head_conv_kernel<BN><<<grid, kThreads, C::kSmem, stream>>>(map_x, map_w, bias, out, batch,
                                                            height, width, cin, cout, ksize);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch (0 =
// success), or kEncodeError + the CUresult where a tensor map is refused.
// x [batch, height, width, cin] and w [cout, ksize, ksize, cin] bf16, 16-byte
// aligned; bias [cout] fp32; out [batch, height, width, cout] bf16. cin and
// cout multiples of 64, ksize odd, batch * ceil(height / 8) * ceil(width /
// 16) * cout / 64 below 2^31 (the wrapper checks all of it).
extern "C" int cdt_head_conv(const void* x, const void* w, const void* bias, void* out,
                             int batch, int height, int width, int cin, int cout, int ksize,
                             void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  if (cin % kBK || cout % 64 || ksize % 2 == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bn = cout % 256 == 0 ? 256 : cout % 128 == 0 ? 128 : 64;
  const cuuint32_t ones[4] = {1, 1, 1, 1};

  CUtensorMap map_x, map_w;
  const cuuint64_t x_dim[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(width),
                               static_cast<cuuint64_t>(height), static_cast<cuuint64_t>(batch)};
  const cuuint64_t x_stride[3] = {static_cast<cuuint64_t>(cin) * 2,
                                  static_cast<cuuint64_t>(width) * cin * 2,
                                  static_cast<cuuint64_t>(height) * width * cin * 2};
  const cuuint32_t x_box[4] = {kBK, kTileW, kTileH, 1};
  CUresult res = cuTensorMapEncodeTiled(
      &map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), x_dim, x_stride, x_box,
      ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kEncodeError + static_cast<int>(res);

  const cuuint64_t depth = static_cast<cuuint64_t>(ksize) * ksize * cin;
  const cuuint64_t w_dim[2] = {depth, static_cast<cuuint64_t>(cout)};
  const cuuint64_t w_stride[1] = {depth * 2};
  const cuuint32_t w_box[2] = {kBK, static_cast<cuuint32_t>(bn)};
  res = cuTensorMapEncodeTiled(&map_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
                               w_dim, w_stride, w_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kEncodeError + static_cast<int>(res);

  const float* b = static_cast<const float*>(bias);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 256) return launch<256>(map_x, map_w, b, o, batch, height, width, cin, cout, ksize, s);
  if (bn == 128) return launch<128>(map_x, map_w, b, o, batch, height, width, cin, cout, ksize, s);
  return launch<64>(map_x, map_w, b, o, batch, height, width, cin, cout, ksize, s);
}

extern "C" const char* cdt_cuda_error_string(int code) {
  if (code >= kEncodeError) {
    static char text[96];
    snprintf(text, sizeof(text), "cuTensorMapEncodeTiled refused a tensor map (CUresult %d)",
             code - kEncodeError);
    return text;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
