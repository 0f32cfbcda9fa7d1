// Native host preprocessing kernels: batched perspective warp + erosion +
// JPEG/PNG decode.
//
// The port's copy of pasta_tpu/native/warp.cpp, unchanged in behaviour
// (tests/test_torch_native.py holds the two builds bit-equal): the host
// data path's threaded C++ library.
// Semantics match cv2 defaults used by the pipeline:
//   warpPerspective — bilinear, BORDER_CONSTANT(0), dst->src inverse mapping,
//       round-to-nearest on uint8 stores.
//   erode (k x k ones) — separable window minimum, +inf border.
// Decode semantics match PIL's np.array(Image.open(...)) for the formats the
// datasets use: JPEG -> RGB/gray u8, PNG -> gray/palette-index/RGB/RGBA u8
// (palette PNGs — the parsing sidecars — yield the INDEX plane, not
// expanded colors, exactly like PIL 'P' mode; 16-bit PNGs are stripped).
//
// Exposed as a plain C ABI for ctypes; threading via std::thread (no GIL).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

inline void warp_one(const uint8_t* src, int sh, int sw, int c,
                     const double* m,  // 3x3 dst->src, row major
                     uint8_t* dst, int dh, int dw) {
  for (int y = 0; y < dh; ++y) {
    for (int x = 0; x < dw; ++x) {
      const double denom = m[6] * x + m[7] * y + m[8];
      uint8_t* out = dst + (static_cast<size_t>(y) * dw + x) * c;
      if (std::fabs(denom) < 1e-12) {
        // Horizon line of the perspective map: BORDER_CONSTANT(0), matching
        // cv2 and the JAX warp (sampling (0,0) here would disagree).
        std::memset(out, 0, c);
        continue;
      }
      const double inv = 1.0 / denom;
      const double sx = (m[0] * x + m[1] * y + m[2]) * inv;
      const double sy = (m[3] * x + m[4] * y + m[5]) * inv;
      const int x0 = static_cast<int>(std::floor(sx));
      const int y0 = static_cast<int>(std::floor(sy));
      if (x0 < -1 || y0 < -1 || x0 >= sw || y0 >= sh) {
        std::memset(out, 0, c);
        continue;
      }
      const double fx = sx - x0;
      const double fy = sy - y0;
      const double w00 = (1 - fx) * (1 - fy);
      const double w01 = fx * (1 - fy);
      const double w10 = (1 - fx) * fy;
      const double w11 = fx * fy;
      for (int ch = 0; ch < c; ++ch) {
        double acc = 0.0;
        const bool in00 = x0 >= 0 && y0 >= 0;
        const bool in01 = x0 + 1 < sw && y0 >= 0;
        const bool in10 = x0 >= 0 && y0 + 1 < sh;
        const bool in11 = x0 + 1 < sw && y0 + 1 < sh;
        if (in00)
          acc += w00 * src[(static_cast<size_t>(y0) * sw + x0) * c + ch];
        if (in01)
          acc += w01 * src[(static_cast<size_t>(y0) * sw + x0 + 1) * c + ch];
        if (in10)
          acc += w10 * src[(static_cast<size_t>(y0 + 1) * sw + x0) * c + ch];
        if (in11)
          acc += w11 * src[(static_cast<size_t>(y0 + 1) * sw + x0 + 1) * c + ch];
        const long r = std::lround(acc);
        out[ch] = static_cast<uint8_t>(std::min(255L, std::max(0L, r)));
      }
    }
  }
}

inline void erode_one(const uint8_t* src, int h, int w, int k, uint8_t* dst,
                      uint8_t* tmp) {
  const int pad_lo = k / 2;
  // horizontal pass
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * w;
    uint8_t* trow = tmp + static_cast<size_t>(y) * w;
    for (int x = 0; x < w; ++x) {
      uint8_t mn = 255;
      const int lo = std::max(0, x - pad_lo);
      const int hi = std::min(w - 1, x - pad_lo + k - 1);
      for (int i = lo; i <= hi; ++i) mn = std::min(mn, row[i]);
      trow[x] = mn;
    }
  }
  // vertical pass
  for (int y = 0; y < h; ++y) {
    const int lo = std::max(0, y - pad_lo);
    const int hi = std::min(h - 1, y - pad_lo + k - 1);
    for (int x = 0; x < w; ++x) {
      uint8_t mn = 255;
      for (int i = lo; i <= hi; ++i)
        mn = std::min(mn, tmp[static_cast<size_t>(i) * w + x]);
      dst[static_cast<size_t>(y) * w + x] = mn;
    }
  }
}

// fn(worker, i): `worker` is a dense per-call worker index in
// [0, min(n, num_threads)) so callers can index per-worker scratch safely
// even if a persistent thread pool is ever introduced.
void parallel_for(int n, int num_threads,
                  const std::function<void(int, int)>& fn) {
  if (n <= 1 || num_threads <= 1) {
    for (int i = 0; i < n; ++i) fn(0, i);
    return;
  }
  std::atomic<int> next(0);
  auto worker = [&](int wid) {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      fn(wid, i);
    }
  };
  std::vector<std::thread> threads;
  const int t = std::min(n, num_threads);
  threads.reserve(t);
  for (int i = 0; i < t; ++i) threads.emplace_back(worker, i);
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Image decode (libjpeg / libpng).

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

// Decodes JPEG bytes. Returns 0 on success, fills h/w/c, writes h*w*c bytes
// into dst (caller guarantees cap). If dst is null, probes dims only.
int decode_jpeg(const uint8_t* data, size_t size, uint8_t* dst, size_t cap,
                int* h, int* w, int* c) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(size));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  // PIL decodes CMYK jpegs too, but the datasets have none; grayscale and
  // YCbCr->RGB cover UPT/DeepFashion/Zalando inputs.
  cinfo.out_color_space =
      cinfo.jpeg_color_space == JCS_GRAYSCALE ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_calc_output_dimensions(&cinfo);
  *h = static_cast<int>(cinfo.output_height);
  *w = static_cast<int>(cinfo.output_width);
  *c = cinfo.out_color_space == JCS_GRAYSCALE ? 1 : 3;
  if (dst == nullptr) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  const size_t row_bytes = static_cast<size_t>(*w) * *c;
  if (row_bytes * *h > cap) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  jpeg_start_decompress(&cinfo);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = dst + row_bytes * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

struct PngReadState {
  const uint8_t* data;
  size_t size;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  auto* s = reinterpret_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + n > s->size) {
    png_error(png, "eof");
    return;
  }
  std::memcpy(out, s->data + s->pos, n);
  s->pos += n;
}

// Decodes PNG bytes with PIL-matching channel semantics (see header note).
int decode_png(const uint8_t* data, size_t size, uint8_t* dst, size_t cap,
               int* h, int* w, int* c) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return 1;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return 1;
  }
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 1;
  }
  PngReadState state{data, size, 0};
  png_set_read_fn(png, &state, png_read_fn);
  png_read_info(png, info);

  const png_byte color = png_get_color_type(png, info);
  if (png_get_bit_depth(png, info) == 16) png_set_strip_16(png);
  if (color != PNG_COLOR_TYPE_PALETTE && png_get_bit_depth(png, info) < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (color == PNG_COLOR_TYPE_PALETTE)
    png_set_packing(png);  // 1/2/4-bit palette indices -> one byte each
  png_read_update_info(png, info);

  *h = static_cast<int>(png_get_image_height(png, info));
  *w = static_cast<int>(png_get_image_width(png, info));
  *c = static_cast<int>(png_get_channels(png, info));
  if (dst == nullptr) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 0;
  }
  const size_t row_bytes = png_get_rowbytes(png, info);
  if (row_bytes * *h > cap ||
      row_bytes != static_cast<size_t>(*w) * *c) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 2;
  }
  rows.resize(*h);
  for (int y = 0; y < *h; ++y) rows[y] = dst + row_bytes * y;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

int decode_any(const uint8_t* data, long size, uint8_t* dst, long cap,
               int* h, int* w, int* c) {
  if (size >= 8 && std::memcmp(data, "\x89PNG\r\n\x1a\n", 8) == 0)
    return decode_png(data, static_cast<size_t>(size), dst,
                      static_cast<size_t>(cap), h, w, c);
  if (size >= 2 && data[0] == 0xFF && data[1] == 0xD8)
    return decode_jpeg(data, static_cast<size_t>(size), dst,
                       static_cast<size_t>(cap), h, w, c);
  return 3;  // unknown format
}

}  // namespace

extern "C" {

// Decode one JPEG/PNG (format sniffed). dst==nullptr probes h/w/c only.
// Returns 0 ok, 1 decode error, 2 buffer too small, 3 unknown format.
int pasta_decode_image(const uint8_t* data, long size, uint8_t* dst, long cap,
                       int* h, int* w, int* c) {
  return decode_any(data, size, dst, cap, h, w, c);
}

// Threaded batch decode of n images with shared output geometry: every
// image must decode to exactly [h, w, c] (the datasets' fixed-size inputs);
// dst is [n, h, w, c]. rc[i] = per-image status (0 ok; 4 = dims mismatch).
void pasta_decode_batch(const uint8_t* const* datas, const long* sizes, int n,
                        uint8_t* dst, int h, int w, int c, int* rc,
                        int num_threads) {
  const size_t stride = static_cast<size_t>(h) * w * c;
  parallel_for(n, num_threads, [&](int, int i) {
    int ih = 0, iw = 0, ic = 0;
    rc[i] = decode_any(datas[i], sizes[i], dst + stride * i,
                       static_cast<long>(stride), &ih, &iw, &ic);
    if (rc[i] == 0 && (ih != h || iw != w || ic != c)) rc[i] = 4;
  });
}

// Batched warp: n jobs; src [n, sh, sw, c] u8, matrices [n, 9] f64
// (dst->src), dst [n, dh, dw, c] u8.
void pasta_warp_perspective_batch(const uint8_t* src, int n, int sh, int sw,
                                  int c, const double* matrices, uint8_t* dst,
                                  int dh, int dw, int num_threads) {
  const size_t src_stride = static_cast<size_t>(sh) * sw * c;
  const size_t dst_stride = static_cast<size_t>(dh) * dw * c;
  parallel_for(n, num_threads, [&](int, int i) {
    warp_one(src + i * src_stride, sh, sw, c, matrices + i * 9,
             dst + i * dst_stride, dh, dw);
  });
}

// Batched erosion: src/dst [n, h, w] u8 single channel.
void pasta_erode_batch(const uint8_t* src, int n, int h, int w, int k,
                       uint8_t* dst, int num_threads) {
  const size_t stride = static_cast<size_t>(h) * w;
  std::vector<std::vector<uint8_t>> scratch(
      static_cast<size_t>(std::max(1, std::min(n, num_threads))));
  parallel_for(n, num_threads, [&](int worker, int i) {
    auto& tmp = scratch[static_cast<size_t>(worker) % scratch.size()];
    if (tmp.size() < stride) tmp.resize(stride);
    erode_one(src + i * stride, h, w, k, dst + i * stride, tmp.data());
  });
}

int pasta_native_version() { return 2; }

}  // extern "C"
