// The Mamba selective scan, fused into one pass over the tokens, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes the scan with
// jax.lax.associative_scan (celldetection_tpu/models/mamba.py:
// selective_scan), which XLA lowers to rounds over [B, L, D, N] arrays. The
// port's torch path does the same in ceil(log2 L) Hillis-Steele rounds; at
// the Mamba CPN's first stage on a 1024^2 tile that is 16 rounds, each
// reading and writing [1, 65536, 512, 16] fp32 gains and states (2.15 GB
// each).
//
// What it computes, all in fp32, for u, delta [B, L, D], A [D, N], Bm, Cm
// [B, L, N] and Dp [D], each read by its own strides:
//   s_t[d, n] = exp(delta_t[d] A[d, n]) s_{t-1}[d, n] + delta_t[d] u_t[d] Bm_t[n],  s_{-1} = 0
//   y_t[d]    = sum_n Cm_t[n] s_t[d, n] + Dp[d] u_t[d]
// into y [B, L, D] contiguous. exp(x) is 2^(x log2(e)), with A log2(e)
// rounded once to fp32, and 2^ a polynomial on the FMA pipe (exp2_poly);
// every state and sum is fp32.
//
// What bounds it on this card: bytes and instruction rate. A call reads u, delta, Bm
// and Cm and writes y: at [1, 65536, 512, 16] that is 0.41 GB, 0.12 ms at
// 3.35 TB/s, the least time; as each token is scanned twice (below), 0.68
// GB. It also takes B L D N = 537 M exponentials twice. Measured on the
// card: with MUFU.EX2 the exponentials did not set the pace (an add in
// place of each took the same time), staging the operands did, until it
// was made asynchronous and double-buffered; but MUFU.EX2 is biased near 1
// (mean relative error -2.3e-8 on [-0.05, 0]), and a state that multiplies
// thousands of gains near 1 drifts with it: a float64 scan's hold read up
// to 1.17 of its tolerance, 0.23 with the polynomial, which costs 0.6 ms
// over the Mamba CPN's four scans of a 1024^2 tile (0.85 -> 1.44 ms).
//
// What the design does about it:
//   - a thread owns one channel and carries its N states in registers along
//     the tokens; nothing of [B, L, D, N] is ever written;
//   - the tokens are cut into chunks, so that enough blocks fill the card
//     (one block: 128 channels x one chunk of one image). Three launches:
//       1. every chunk but the last scans from a zero state and writes its
//          end state and the sum of its delta (a few MB);
//       2. a thread per (image, channel, state) carries the states across
//          the chunks in order: carry_{k+1} = exp(A sum_k delta) carry_k +
//          end_k, the chunk's whole decay, written over the end states;
//       3. every chunk scans again from its true carry-in and writes y;
//   - tiles of 16 tokens x 128 channels of u and delta, and the tile's rows
//     of Bm and Cm (columns of the x_proj output), are copied to shared
//     memory by cp.async, consecutive threads on consecutive addresses of
//     whichever axis is contiguous: delta's channels, and the tokens of u,
//     which arrives as a transposed [B, D, L] tensor. Two buffers: the
//     copies of the next tile are in flight while a tile is scanned. Every
//     thread reads Bm and Cm as broadcasts;
//   - per token and state a thread does two multiplies, the exponential
//     and one fused multiply-add (and one more for y); the output's sum over
//     the states runs in four partial sums, so the states give independent
//     chains.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;        // channels a block, one a thread
constexpr int kTile = 16;            // tokens a staged tile; two tiles in flight a block
constexpr int kPitch = kThreads + 2; // floats a staged row of channels (see Tile)
constexpr int kCarryThreads = 64;    // small blocks: the carry's threads spread over the SMs
constexpr int kCarryUnroll = 32;     // chunks whose loads a carry thread keeps in flight
constexpr float kLog2e = 1.4426950408889634f;

struct Operand {
  const float* p;
  long long sb, st, sc;              // strides: batch, token, channel (or state)
};

// 2^x on the FMA pipe: x = j + f with j an integer (x + 1.5 * 2^23 rounds
// it into the float's low bits) and f in [-1/2, 1/2], 2^f by a degree-6
// polynomial (relative error 1.9e-9, 1.3 ulp after fp32 Horner, mean 4e-10),
// 2^j added to the exponent. x is clamped at -125, so a gain is never below
// 2^-125 (2.4e-38), where it would be smaller.
__device__ __forceinline__ float exp2_poly(float x) {
  x = fmaxf(x, -125.f);
  const float t = x + 12582912.f;
  const float f = x - (t - 12582912.f);
  float p = 1.5337577497120947e-4f;
  p = fmaf(p, f, 1.3399859890341759e-3f);
  p = fmaf(p, f, 9.618519805371761e-3f);
  p = fmaf(p, f, 5.550329014658928e-2f);
  p = fmaf(p, f, 2.4022646248340607e-1f);
  p = fmaf(p, f, 6.931471824645996e-1f);
  p = fmaf(p, f, 1.f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) - 0x4B400000) * 8388608);
}

// An asynchronous 4-byte copy from device to shared memory (no register
// holds it), and the group fences of such copies.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_copies_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One staged tile: tokens x 128 channels of u and delta, [token][channel],
// and tokens x N of Bm and Cm. Rows of kThreads + 2 floats keep the three
// ways of touching u and delta free of bank conflicts: a warp filling 32
// channels of a token, a warp filling 16 tokens of 2 channels (banks 2t + c),
// and a warp reading 32 channels of a token.
template <int N, bool kFinal>
struct Tile {
  float u[kTile][kPitch], dt[kTile][kPitch];
  float b[kTile][N];
  float c[kFinal ? kTile : 1][N];
};

// Tokens [tt, tt + n_t) x channels [d0, d0 + kThreads) of image b into
// dst[token][channel], consecutive threads on consecutive addresses of the
// contiguous axis: the channels (delta) or the tokens (u, a transposed view).
__device__ __forceinline__ void stage_channels(float (*dst)[kPitch], const Operand& o, int b,
                                               int tt, int n_t, int d0, int channels) {
  const float* base = o.p + b * o.sb + tt * o.st + d0 * o.sc;
  const int live = min(kThreads, channels - d0);
  if (o.sc == 1) {
    const int c = threadIdx.x;
    if (c < live)
      for (int t = 0; t < n_t; ++t) copy_async(&dst[t][c], base + t * o.st + c);
  } else {
#pragma unroll
    for (int i = threadIdx.x; i < kTile * kThreads; i += kThreads) {
      const int c = i / kTile, t = i % kTile;
      if (t < n_t && c < live) copy_async(&dst[t][c], base + t * o.st + c * o.sc);
    }
  }
}

// Tokens [tt, tt + n_t) x the N states of image b into dst[token][state].
template <int N>
__device__ __forceinline__ void stage_states(float (*dst)[N], const Operand& o, int b, int tt,
                                             int n_t) {
  const float* base = o.p + b * o.sb + tt * o.st;
#pragma unroll
  for (int i = threadIdx.x; i < kTile * N; i += kThreads) {
    const int t = i / N, n = i % N;
    if (t < n_t) copy_async(&dst[t][n], base + t * o.st + n * o.sc);
  }
}

// Launch 1 (kFinal false) over chunks 0 .. chunks - 2: the end state of each
// from a zero state into carry[b, k], the sum of its delta into sumdt[b, k].
// Launch 3 (kFinal true) over every chunk: the scan from carry[b, k - 1]
// (zero for k = 0), y written. carry is [B, chunks - 1, D, N], sumdt
// [B, chunks - 1, D]. The tiles of a chunk go through two buffers: the
// copies of tile i + 1 are in flight while tile i is scanned.
template <int N, bool kFinal>
__global__ void __launch_bounds__(kThreads, 5)
    scan_chunks(Operand u, Operand dt, Operand bm, Operand cm, const float* __restrict__ A,
                long long sa_d, long long sa_n, const float* __restrict__ Dp, long long sd,
                float* __restrict__ carry, float* __restrict__ sumdt, float* __restrict__ y,
                int length, int channels, int chunk, int chunks) {
  __shared__ __align__(16) Tile<N, kFinal> tiles[2];
  const int d0 = blockIdx.x * kThreads, k = blockIdx.y, b = blockIdx.z;
  const int d = d0 + threadIdx.x;
  const bool live = d < channels;
  const int t0 = k * chunk, t1 = min(length, t0 + chunk);
  const int count = (t1 - t0 + kTile - 1) / kTile;
  const long long slot =
      (static_cast<long long>(b) * (chunks - 1) + (kFinal ? k - 1 : k)) * channels + d;

  auto stage = [&](Tile<N, kFinal>& tile, int tt) {
    const int n_t = min(kTile, t1 - tt);
    stage_channels(tile.u, u, b, tt, n_t, d0, channels);
    stage_channels(tile.dt, dt, b, tt, n_t, d0, channels);
    stage_states<N>(tile.b, bm, b, tt, n_t);
    if constexpr (kFinal) stage_states<N>(tile.c, cm, b, tt, n_t);
  };
  stage(tiles[0], t0);
  commit_copies();

  float a2[N], s[N];
#pragma unroll
  for (int n = 0; n < N; ++n) a2[n] = live ? A[d * sa_d + n * sa_n] * kLog2e : 0.f;
  if (kFinal && k > 0 && live) {
    const float4* in = reinterpret_cast<const float4*>(carry + slot * N);
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 v = in[q];
      s[4 * q] = v.x, s[4 * q + 1] = v.y, s[4 * q + 2] = v.z, s[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) s[n] = 0.f;
  }
  const float skip = kFinal && live ? Dp[d * sd] : 0.f;
  float total = 0.f;

  for (int i = 0; i < count; ++i) {
    const int tt = t0 + i * kTile, n_t = min(kTile, t1 - tt);
    if (i + 1 < count) stage(tiles[(i + 1) & 1], tt + kTile);
    commit_copies();                 // (an empty group after the last tile)
    wait_copies_but_last();          // this thread's copies of tile i have landed
    __syncthreads();                 // and every thread's
    const Tile<N, kFinal>& tile = tiles[i & 1];
    if (live) {
      float* out = y + (static_cast<long long>(b) * length + tt) * channels + d;
      for (int t = 0; t < n_t; ++t) {
        const float delta = tile.dt[t][threadIdx.x], x = tile.u[t][threadIdx.x];
        const float du = delta * x;
        total += delta;
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float g = exp2_poly(delta * a2[n]);
          s[n] = fmaf(g, s[n], du * tile.b[t][n]);
          if constexpr (kFinal) part[n % 4] = fmaf(s[n], tile.c[t][n], part[n % 4]);
        }
        if constexpr (kFinal)
          out[static_cast<long long>(t) * channels] =
              ((part[0] + part[1]) + (part[2] + part[3])) + skip * x;
      }
    }
    __syncthreads();                 // tile i is read before its buffer takes tile i + 2
  }

  if (!kFinal && live) {
    float4* dst = reinterpret_cast<float4*>(carry + slot * N);
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      dst[q] = make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
    sumdt[slot] = total;
  }
}

// Launch 2: one thread a (image, channel, state) walks the chunks in order;
// slot k becomes the state entering chunk k + 1.
template <int N>
__global__ void __launch_bounds__(kCarryThreads)
    scan_carry(const float* __restrict__ A, long long sa_d, long long sa_n,
               const float* __restrict__ sumdt, float* __restrict__ carry, int channels,
               int links, long long lanes) {
  const long long i = static_cast<long long>(blockIdx.x) * kCarryThreads + threadIdx.x;
  if (i >= lanes) return;
  const int n = static_cast<int>(i % N);
  const long long bd = i / N;
  const int d = static_cast<int>(bd % channels);
  const long long b = bd / channels;
  const float a2 = A[d * sa_d + n * sa_n] * kLog2e;
  float* c = carry + (b * links * channels + d) * N + n;
  const float* sum = sumdt + b * links * channels + d;
  const long long step = static_cast<long long>(channels) * N;
  float state = 0.f;
  for (int k0 = 0; k0 < links; k0 += kCarryUnroll) {
    float end[kCarryUnroll], w[kCarryUnroll];
#pragma unroll
    for (int j = 0; j < kCarryUnroll; ++j)
      if (k0 + j < links) {
        end[j] = c[(k0 + j) * step];
        w[j] = sum[static_cast<long long>(k0 + j) * channels];
      }
#pragma unroll
    for (int j = 0; j < kCarryUnroll; ++j)
      if (k0 + j < links) {
        state = fmaf(exp2_poly(a2 * w[j]), state, end[j]);
        c[(k0 + j) * step] = state;
      }
  }
}

template <int N>
int launch(const Operand& u, const Operand& dt, const Operand& bm, const Operand& cm,
           const float* A, long long sa_d, long long sa_n, const float* Dp, long long sd,
           float* carry, float* sumdt, float* y, int batch, int length, int channels, int chunk,
           cudaStream_t stream) {
  const int chunks = (length + chunk - 1) / chunk;
  const int groups = (channels + kThreads - 1) / kThreads;
  if (chunks > 1) {
    scan_chunks<N, false><<<dim3(groups, chunks - 1, batch), kThreads, 0, stream>>>(
        u, dt, bm, cm, A, sa_d, sa_n, Dp, sd, carry, sumdt, y, length, channels, chunk, chunks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long lanes = static_cast<long long>(batch) * channels * N;
    scan_carry<N><<<static_cast<unsigned>((lanes + kCarryThreads - 1) / kCarryThreads),
                    kCarryThreads, 0, stream>>>(A, sa_d, sa_n, sumdt, carry, channels,
                                                chunks - 1, lanes);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scan_chunks<N, true><<<dim3(groups, chunks, batch), kThreads, 0, stream>>>(
      u, dt, bm, cm, A, sa_d, sa_n, Dp, sd, carry, sumdt, y, length, channels, chunk, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launches (0 =
// success). strides holds, in elements: u's, delta's, Bm's and Cm's (batch,
// token, channel or state), A's (channel, state) and Dp's, 15 in all.
// carry [batch, chunks - 1, channels, states] (16-byte aligned) and sumdt
// [batch, chunks - 1, channels] are scratch, y [batch, length, channels] the
// output, with chunks = ceil(length / chunk). states 4, 8 or 16; chunk a
// multiple of 16; batch and chunks at most 65535 (the wrapper checks all of
// it).
extern "C" int cdt_selective_scan(const void* u, const void* delta, const void* A, const void* B,
                                  const void* C, const void* D, void* carry, void* sumdt, void* y,
                                  const long long* strides, int batch, int length, int channels,
                                  int states, int chunk, void* stream) {
  if (batch <= 0 || length <= 0 || channels <= 0) return 0;
  if (chunk <= 0 || chunk % kTile) return static_cast<int>(cudaErrorInvalidValue);
  const long long* s = strides;
  const Operand ou{static_cast<const float*>(u), s[0], s[1], s[2]};
  const Operand odt{static_cast<const float*>(delta), s[3], s[4], s[5]};
  const Operand ob{static_cast<const float*>(B), s[6], s[7], s[8]};
  const Operand oc{static_cast<const float*>(C), s[9], s[10], s[11]};
  const float* a = static_cast<const float*>(A);
  const float* dp = static_cast<const float*>(D);
  float* cr = static_cast<float*>(carry);
  float* sm = static_cast<float*>(sumdt);
  float* out = static_cast<float*>(y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (states) {
    case 4:
      return launch<4>(ou, odt, ob, oc, a, s[12], s[13], dp, s[14], cr, sm, out, batch, length,
                       channels, chunk, st);
    case 8:
      return launch<8>(ou, odt, ob, oc, a, s[12], s[13], dp, s[14], cr, sm, out, batch, length,
                       channels, chunk, st);
    case 16:
      return launch<16>(ou, odt, ob, oc, a, s[12], s[13], dp, s[14], cr, sm, out, batch, length,
                        channels, chunk, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cdt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
