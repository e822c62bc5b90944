// Native JPEG decode + resize for the host input pipeline (the port's copy
// of geoguessr_ai_tpu/data/native/jpeg_decode.cpp; the code is the same,
// so both decoders give the same bits).
//
// libjpeg with DCT-domain downscaling (decode at the largest M/8 scale that
// still covers the target, cutting IDCT work ~2x for 640->512) followed by
// separable bilinear resize, fanned out over a std::thread pool.  Exposed as
// a C API consumed via ctypes.
//
// Built at first use by jpeg.py into build/native/ of the checkout:
//   g++ -O3 -march=native -shared -fPIC -o _jpeg_native.so \
//       jpeg_decode.cpp -ljpeg -lpthread

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Bilinear resize HxWx3 uint8 -> out_h x out_w x 3.
void bilinear_resize(const uint8_t* src, int h, int w, uint8_t* dst,
                     int out_h, int out_w) {
  if (h == out_h && w == out_w) {
    std::memcpy(dst, src, static_cast<size_t>(h) * w * 3);
    return;
  }
  const float sy = static_cast<float>(h) / out_h;
  const float sx = static_cast<float>(w) / out_w;
  std::vector<int> x0v(out_w), x1v(out_w);
  std::vector<float> fxv(out_w);
  for (int x = 0; x < out_w; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    fx = std::max(0.0f, std::min(fx, static_cast<float>(w - 1)));
    int x0 = static_cast<int>(fx);
    x0v[x] = x0;
    x1v[x] = std::min(x0 + 1, w - 1);
    fxv[x] = fx - x0;
  }
  for (int y = 0; y < out_h; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(h - 1)));
    int y0 = static_cast<int>(fy);
    int y1 = std::min(y0 + 1, h - 1);
    float wy = fy - y0;
    const uint8_t* r0 = src + static_cast<size_t>(y0) * w * 3;
    const uint8_t* r1 = src + static_cast<size_t>(y1) * w * 3;
    uint8_t* out_row = dst + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      int x0 = x0v[x] * 3, x1 = x1v[x] * 3;
      float wx = fxv[x];
      for (int c = 0; c < 3; ++c) {
        float top = r0[x0 + c] + wx * (r0[x1 + c] - r0[x0 + c]);
        float bot = r1[x0 + c] + wx * (r1[x1 + c] - r1[x0 + c]);
        float v = top + wy * (bot - top);
        out_row[x * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// Decode one JPEG into out (out_h x out_w x 3, RGB).  Returns 0 on success.
int decode_one(const uint8_t* data, size_t len, uint8_t* out, int out_h,
               int out_w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  // Raw malloc'd scanline buffer, declared before setjmp: the error_exit
  // longjmp must not cross any live object with a non-trivial destructor
  // (UB), and a std::vector declared after setjmp would also leak its
  // allocation on every mid-scanline decode error.  volatile-qualified so
  // the pointer value is well-defined after longjmp.
  uint8_t* volatile buf = nullptr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    std::free(const_cast<uint8_t*>(buf));
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;
  // DCT-domain downscale: largest num/8 <= 1 with scaled dims >= target.
  cinfo.scale_denom = 8;
  cinfo.scale_num = 8;
  for (int num = 1; num <= 8; ++num) {
    long sh = (static_cast<long>(cinfo.image_height) * num + 7) / 8;
    long sw = (static_cast<long>(cinfo.image_width) * num + 7) / 8;
    if (sh >= out_h && sw >= out_w) {
      cinfo.scale_num = num;
      break;
    }
  }
  cinfo.dct_method = JDCT_ISLOW;
  jpeg_start_decompress(&cinfo);
  const int h = cinfo.output_height;
  const int w = cinfo.output_width;
  if (cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  buf = static_cast<uint8_t*>(std::malloc(static_cast<size_t>(h) * w * 3));
  if (buf == nullptr) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 4;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = const_cast<uint8_t*>(buf) +
                   static_cast<size_t>(cinfo.output_scanline) * w * 3;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  bilinear_resize(const_cast<uint8_t*>(buf), h, w, out, out_h, out_w);
  std::free(const_cast<uint8_t*>(buf));
  return 0;
}

}  // namespace

extern "C" {

int gg_decode_resize(const uint8_t* data, size_t len, uint8_t* out,
                     int out_h, int out_w) {
  return decode_one(data, len, out, out_h, out_w);
}

// Batch decode with a thread pool.  jpegs/lens: n buffers; out: contiguous
// (n, out_h, out_w, 3).  status: per-image return codes (0 = ok).
void gg_decode_batch(const uint8_t** jpegs, const size_t* lens, int n,
                     uint8_t* out, int out_h, int out_w, int n_threads,
                     int* status) {
  const size_t stride = static_cast<size_t>(out_h) * out_w * 3;
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      status[i] = decode_one(jpegs[i], lens[i], out + stride * i, out_h,
                             out_w);
    }
  };
  n_threads = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(n_threads - 1);
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

}  // extern "C"
