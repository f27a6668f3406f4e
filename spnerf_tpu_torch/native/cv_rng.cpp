// OpenCV's cv::RNG (multiply-with-carry on a 64-bit state) filling an
// 8-bit array as cv::randu does for a range that is not a power of two:
// each element lo + next() % d, in order. Returns the new state.
#include <cstddef>
#include <cstdint>

extern "C" uint64_t cv_rng_fill_u8(uint64_t state, uint8_t* out, int64_t n,
                                   int32_t lo, uint32_t d) {
  for (int64_t i = 0; i < n; ++i) {
    state = (uint64_t)(uint32_t)state * 4164903690ULL + (state >> 32);
    out[i] = (uint8_t)(lo + (int32_t)((uint32_t)state % d));
  }
  return state;
}
