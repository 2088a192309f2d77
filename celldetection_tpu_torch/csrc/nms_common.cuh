// What nms_bits.cu and nms_resolve.cu share: the block size and the two
// layouts of the stored suppression words.
#pragma once

#include <stddef.h>

namespace cdt_nms {

constexpr int kBlock = 64;  // boxes per block = bits per word

// One non-zero word of a row in a later block: bit l says box `row` suppresses
// box 64 * word + l of its image. ops/boxes.py reads it as int64 [P, 2]:
// (bits, row | word << 32).
struct __align__(16) Pair {
  unsigned long long bits;
  int row;   // b * n + i
  int word;  // column block c
};

// The slots layout (small images): every later word of every row has a slot,
// block after block (all images of a block together), row after row: row l
// of block r of image b holds the words of column blocks r + 1 .. nb - 1 at
// slot_of(r, b) + l * (nb - 1 - r), zero where a word is zero. (The packed
// layout of larger images keeps only the non-zero words, at offsets that a
// prefix sum of their counts gives.)
__host__ __device__ __forceinline__ size_t slot_of(int r, int b, int batch, int nb) {
  const size_t before = static_cast<size_t>(r) * (nb - 1) - static_cast<size_t>(r) * (r - 1) / 2;
  return (before * batch + static_cast<size_t>(b) * (nb - 1 - r)) * kBlock;
}

}  // namespace cdt_nms
