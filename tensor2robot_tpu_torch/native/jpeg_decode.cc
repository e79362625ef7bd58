// Native batched JPEG decode.
//
// The host-side image decode bound is the GIL: PIL's decoder holds it,
// so Python-level threading gives little.
// This decoder uses libjpeg directly from a std::thread pool — fully
// GIL-free, scaling with host cores — for the spec-driven fixed-shape
// case that feeds training (every record decodes to the same
// [H, W, C]). Anything else (PNG/GIF/BMP, dynamic shapes, corrupt or
// empty payloads) falls back to the Python path.

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
#include <jpeglib.h>
}

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

void silent_output(j_common_ptr) {}

// Decodes one JPEG into out[h * w * c]; returns false on any mismatch
// (dimensions, corruption) so the caller can fall back.
bool decode_one(const uint8_t* data, int64_t len, uint8_t* out,
                int64_t h, int64_t w, int64_t c) {
  if (data == nullptr || len <= 0) return false;
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = silent_output;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  if (c == 1 && cinfo.jpeg_color_space != JCS_GRAYSCALE) {
    // Color -> grayscale conversion rounds differently from PIL's
    // RGB -> L; bail so the caller's PIL path keeps outputs identical
    // regardless of which build is present.
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = (c == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  bool ok = (static_cast<int64_t>(cinfo.output_height) == h &&
             static_cast<int64_t>(cinfo.output_width) == w &&
             static_cast<int64_t>(cinfo.output_components) == c);
  if (ok) {
    int64_t stride = w * c;
    while (cinfo.output_scanline < cinfo.output_height) {
      JSAMPROW row = out + cinfo.output_scanline * stride;
      if (jpeg_read_scanlines(&cinfo, &row, 1) != 1) {
        ok = false;
        break;
      }
    }
  }
  if (ok) {
    jpeg_finish_decompress(&cinfo);
  }
  jpeg_destroy_decompress(&cinfo);
  return ok;
}

}  // namespace

extern "C" {

// Decodes n JPEG buffers into a dense uint8 [n, h, w, c] array using
// `num_threads` workers (0 -> hardware concurrency, capped at 16).
// Returns 0 on success; -1 if ANY image fails to decode to exactly
// (h, w, c) — all-or-nothing so the caller's fallback sees the whole
// batch through one code path.
int t2r_decode_jpeg_batch(const uint8_t** datas, const int64_t* lens,
                          int64_t n, uint8_t* out, int64_t h, int64_t w,
                          int64_t c, int num_threads) {
  if (n <= 0) return 0;
  if (c != 1 && c != 3) return -1;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (num_threads <= 0) num_threads = hw > 0 ? hw : 4;
  if (num_threads > 16) num_threads = 16;
  if (num_threads > n) num_threads = static_cast<int>(n);
  int64_t image_size = h * w * c;
  std::atomic<int64_t> next(0);
  std::atomic<bool> failed(false);

  auto worker = [&]() {
    while (!failed.load(std::memory_order_relaxed)) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      if (!decode_one(datas[i], lens[i], out + i * image_size, h, w, c)) {
        failed.store(true, std::memory_order_relaxed);
        return;
      }
    }
  };

  if (num_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(num_threads);
    for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return failed.load() ? -1 : 0;
}

}  // extern "C"
