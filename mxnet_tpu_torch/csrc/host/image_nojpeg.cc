// The image entry points of src/native/image.cc for a host without
// libjpeg: the bilinear resize (the same routine, so the two builds resize
// alike), MXTBufFree, and an MXTDecodeJPEG that refuses.  The port's host
// library links this file in place of image.cc when <jpeglib.h> is absent
// (mxnet_tpu_torch/native.py, route "raw"); it has no MXTEncodeJPEG, which
// is how the loader tells the two builds apart.  The image loader of
// src/native/dataloader.cc then reads raw u8 npy payloads only, and
// mxnet_tpu_torch.native refuses a JPEG pack before the loader starts.
#include "common.h"

#include <cstdlib>

extern "C" {

MXT_EXPORT void MXTBufFree(void* ptr) { std::free(ptr); }

MXT_EXPORT int MXTDecodeJPEG(const uint8_t* buf, uint64_t len, void** out,
                             int* height, int* width, int* channels) {
  (void)buf;
  (void)len;
  (void)out;
  (void)height;
  (void)width;
  (void)channels;
  mxt::SetLastError("this host library was built without libjpeg");
  return -1;
}

// Bilinear resize of packed u8 HWC (src/native/image.cc's routine).
MXT_EXPORT void MXTImageResizeBilinear(const uint8_t* src, int sh, int sw,
                                       int c, uint8_t* dst, int dh, int dw) {
  const float ry = dh > 1 ? float(sh - 1) / (dh - 1) : 0.f;
  const float rx = dw > 1 ? float(sw - 1) / (dw - 1) : 0.f;
  for (int y = 0; y < dh; ++y) {
    float fy = y * ry;
    int y0 = int(fy);
    int y1 = y0 + 1 < sh ? y0 + 1 : y0;
    float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = x * rx;
      int x0 = int(fx);
      int x1 = x0 + 1 < sw ? x0 + 1 : x0;
      float wx = fx - x0;
      for (int k = 0; k < c; ++k) {
        float v00 = src[(size_t(y0) * sw + x0) * c + k];
        float v01 = src[(size_t(y0) * sw + x1) * c + k];
        float v10 = src[(size_t(y1) * sw + x0) * c + k];
        float v11 = src[(size_t(y1) * sw + x1) * c + k];
        float top = v00 + wx * (v01 - v00);
        float bot = v10 + wx * (v11 - v10);
        dst[(size_t(y) * dw + x) * c + k] =
            static_cast<uint8_t>(top + wy * (bot - top) + 0.5f);
      }
    }
  }
}

}  // extern "C"
