// Host routine (no kernel): FAST-VQA's mini-patches cut out of packed I420
// frames into one pinned staging buffer, for features/fastvqa.py.
//
// Each mini-patch of 32x32 pixels is taken as the even-aligned 34x34 luma
// region around it and that region's 17x17 U and V (nearest 2x2 chroma, so
// the device's converter gives the patch's pixels bit-exactly, and the
// device crops the patch by a shift of 0-2 rows and columns).  A region is
// 34 rows of 34 bytes and 2 x 17 rows of 17 bytes: the copy is made of runs
// too short for numpy's per-slice overhead (about 20 ms a 540p video of 4
// clips x 32 frames x 49 patches there, against memcpy's few ms here).  The
// plain version is features/fastvqa.py::crop_i420_plain.

#include <stdint.h>
#include <string.h>

namespace {
constexpr int R = 34;      // luma region side
constexpr int RC = R / 2;  // chroma region side
}  // namespace

// src: `frames` packed I420 frames of h x w, contiguous; tops, lefts: the
// even-aligned region origins of `patches` patches (the caller checked them
// against the frame); dst: (frames, patches, R*R + 2*RC*RC) uint8.
extern "C" int relax_crop_i420_minipatches(const void* src, int frames, int h, int w, const void* tops,
                                           const void* lefts, int patches, void* dst) {
  const long long fbytes = (long long)h * w * 3 / 2;
  const long long out_bytes = R * R + 2 * RC * RC;
  const int* top = static_cast<const int*>(tops);
  const int* left = static_cast<const int*>(lefts);
  const int wc = w / 2;
  for (int f = 0; f < frames; ++f) {
    const uint8_t* y = static_cast<const uint8_t*>(src) + f * fbytes;
    const uint8_t* u = y + (long long)h * w;
    const uint8_t* v = u + (long long)(h / 2) * wc;
    for (int p = 0; p < patches; ++p) {
      uint8_t* o = static_cast<uint8_t*>(dst) + ((long long)f * patches + p) * out_bytes;
      const uint8_t* ys = y + (long long)top[p] * w + left[p];
      for (int r = 0; r < R; ++r) memcpy(o + r * R, ys + (long long)r * w, R);
      const long long c0 = (long long)(top[p] / 2) * wc + left[p] / 2;
      uint8_t* ou = o + R * R;
      uint8_t* ov = ou + RC * RC;
      for (int r = 0; r < RC; ++r) {
        memcpy(ou + r * RC, u + c0 + (long long)r * wc, RC);
        memcpy(ov + r * RC, v + c0 + (long long)r * wc, RC);
      }
    }
  }
  return 0;
}
