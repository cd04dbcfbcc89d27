// perseus_io: native image-decode backend for the training data path.
//
// The port's copy of perseus_tpu/native/src/perseus_io.cpp. One C++ thread
// pool decodes whole batches directly into preallocated contiguous NHWC
// float buffers, in place of per-item PIL decodes in Python: no Python per
// item, no GIL (the ctypes call releases it), no inter-process copies. PNG
// via libpng; depth via a minimal reader for the uncompressed float32 TIFFs
// this framework writes (PIL mode-"F" layout). Host code: it never touches
// the card.
//
// Exposed as a plain C ABI for ctypes.

#include <png.h>
#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

thread_local std::string g_error;

struct PngReadCtx {
  FILE* f;
};

bool decode_png(const char* path, std::vector<uint8_t>* out, int* height,
                int* width, int* channels) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    g_error = std::string("open failed: ") + path;
    return false;
  }
  png_byte header[8];
  if (fread(header, 1, 8, f) != 8 || png_sig_cmp(header, 0, 8)) {
    fclose(f);
    g_error = std::string("not a png: ") + path;
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info) {
    if (png) png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    g_error = "libpng alloc failed";
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    g_error = std::string("png decode error: ") + path;
    return false;
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);

  // normalize to 8-bit; expand palette/gray-with-less-than-8bpp
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_read_update_info(png, info);

  int c = png_get_channels(png, info);
  out->resize(static_cast<size_t>(h) * w * c);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = out->data() + static_cast<size_t>(y) * w * c;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  *height = static_cast<int>(h);
  *width = static_cast<int>(w);
  *channels = c;
  return true;
}

uint32_t rd32(const uint8_t* p, bool le) {
  return le ? (p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24)
            : (p[3] | p[2] << 8 | p[1] << 16 | (uint32_t)p[0] << 24);
}
uint16_t rd16(const uint8_t* p, bool le) {
  return le ? (p[0] | p[1] << 8) : (p[1] | p[0] << 8);
}

// Minimal baseline-TIFF reader for uncompressed float32 single-sample images
// (the layout PIL writes for mode-"F", which is what data/schema.py emits).
bool decode_float_tiff(const char* path, std::vector<float>* out, int* height,
                       int* width) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    g_error = std::string("open failed: ") + path;
    return false;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(size);
  if (fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    g_error = std::string("short read: ") + path;
    return false;
  }
  fclose(f);
  if (size < 8) {
    g_error = "tiff too small";
    return false;
  }
  bool le;
  if (buf[0] == 'I' && buf[1] == 'I')
    le = true;
  else if (buf[0] == 'M' && buf[1] == 'M')
    le = false;
  else {
    g_error = std::string("not a tiff: ") + path;
    return false;
  }
  if (rd16(&buf[2], le) != 42) {
    g_error = "bad tiff magic";
    return false;
  }
  uint32_t ifd = rd32(&buf[4], le);
  if (ifd + 2 > static_cast<uint32_t>(size)) {
    g_error = "bad ifd offset";
    return false;
  }
  uint16_t n_entries = rd16(&buf[ifd], le);
  uint32_t w = 0, h = 0, bits = 0, comp = 1, sf = 1, rows_per_strip = 0xffffffff;
  std::vector<uint32_t> strip_offsets, strip_counts;

  auto read_entry_values = [&](const uint8_t* e, std::vector<uint32_t>* vals) {
    uint16_t type = rd16(e + 2, le);
    uint32_t count = rd32(e + 4, le);
    int esize = type == 3 ? 2 : (type == 4 ? 4 : 0);
    if (esize == 0) return;  // unsupported element type for our tags
    vals->clear();
    const uint8_t* src;
    if (esize * count <= 4)
      src = e + 8;
    else {
      uint32_t off = rd32(e + 8, le);
      if (off + esize * count > static_cast<uint32_t>(size)) return;
      src = buf.data() + off;
    }
    for (uint32_t i = 0; i < count; ++i)
      vals->push_back(esize == 2 ? rd16(src + 2 * i, le) : rd32(src + 4 * i, le));
  };

  std::vector<uint32_t> vals;
  for (uint16_t i = 0; i < n_entries; ++i) {
    const uint8_t* e = buf.data() + ifd + 2 + 12 * i;
    if (e + 12 > buf.data() + size) break;
    uint16_t tag = rd16(e, le);
    read_entry_values(e, &vals);
    if (vals.empty()) continue;
    switch (tag) {
      case 256: w = vals[0]; break;
      case 257: h = vals[0]; break;
      case 258: bits = vals[0]; break;
      case 259: comp = vals[0]; break;
      case 273: strip_offsets = vals; break;
      case 278: rows_per_strip = vals[0]; break;
      case 279: strip_counts = vals; break;
      case 339: sf = vals[0]; break;
    }
  }
  if (comp != 1 || bits != 32 || sf != 3 || w == 0 || h == 0 ||
      strip_offsets.empty()) {
    g_error = std::string("unsupported tiff (need uncompressed float32): ") + path;
    return false;
  }
  out->resize(static_cast<size_t>(w) * h);
  size_t written = 0;
  for (size_t s = 0; s < strip_offsets.size(); ++s) {
    uint32_t off = strip_offsets[s];
    uint32_t cnt = s < strip_counts.size()
                       ? strip_counts[s]
                       : static_cast<uint32_t>(out->size() * 4 - written * 4);
    if (off + cnt > static_cast<uint32_t>(size) ||
        written * 4 + cnt > out->size() * 4) {
      g_error = "tiff strip out of bounds";
      return false;
    }
    std::memcpy(reinterpret_cast<uint8_t*>(out->data()) + written * 4,
                buf.data() + off, cnt);
    written += cnt / 4;
  }
  if (!le) {  // byte-swap big-endian floats
    uint8_t* p = reinterpret_cast<uint8_t*>(out->data());
    for (size_t i = 0; i < out->size(); ++i) {
      std::swap(p[4 * i], p[4 * i + 3]);
      std::swap(p[4 * i + 1], p[4 * i + 2]);
    }
  }
  *height = static_cast<int>(h);
  *width = static_cast<int>(w);
  return true;
}

// Decodes one training example into float32 buffers. seg is binarized as
// (label == asset_id + 1), matching reference perseus/detector/data.py:88-91.
bool decode_example(const char* rgb_path, const char* depth_path,
                    const char* seg_path, long asset_id, int h, int w,
                    float* rgb_out, float* depth_out, float* seg_out) {
  std::vector<uint8_t> px;
  int ih, iw, ic;
  if (!decode_png(rgb_path, &px, &ih, &iw, &ic)) return false;
  if (ih != h || iw != w || ic < 3) {
    g_error = std::string("rgb shape mismatch: ") + rgb_path;
    return false;
  }
  // LUT computed in double then rounded once — bit-identical to numpy's
  // (uint8 / 255.0).astype(float32) path used by the PIL fallback.
  static const auto lut = [] {
    std::vector<float> t(256);
    for (int i = 0; i < 256; ++i) t[i] = static_cast<float>(i / 255.0);
    return t;
  }();
  for (int i = 0; i < h * w; ++i) {
    rgb_out[3 * i] = lut[px[ic * i]];
    rgb_out[3 * i + 1] = lut[px[ic * i + 1]];
    rgb_out[3 * i + 2] = lut[px[ic * i + 2]];
  }
  if (depth_path && depth_out) {
    std::vector<float> d;
    if (!decode_float_tiff(depth_path, &d, &ih, &iw)) return false;
    if (ih != h || iw != w) {
      g_error = std::string("depth shape mismatch: ") + depth_path;
      return false;
    }
    std::memcpy(depth_out, d.data(), sizeof(float) * h * w);
  }
  if (seg_path && seg_out) {
    if (!decode_png(seg_path, &px, &ih, &iw, &ic)) return false;
    if (ih != h || iw != w) {
      g_error = std::string("seg shape mismatch: ") + seg_path;
      return false;
    }
    uint8_t target = static_cast<uint8_t>(asset_id + 1);
    for (int i = 0; i < h * w; ++i)
      seg_out[i] = px[ic * i] == target ? 1.0f : 0.0f;
  }
  return true;
}

}  // namespace

extern "C" {

const char* pio_last_error() { return g_error.c_str(); }

int pio_decode_example(const char* rgb_path, const char* depth_path,
                       const char* seg_path, long asset_id, int h, int w,
                       float* rgb_out, float* depth_out, float* seg_out) {
  return decode_example(rgb_path, depth_path, seg_path, asset_id, h, w, rgb_out,
                        depth_out, seg_out)
             ? 0
             : 1;
}

// Batch decode with an internal thread pool. Outputs are dense NHWC blocks:
// rgb_out (n, h, w, 3); depth_out (n, h, w) or null; seg_out likewise.
// Returns the number of failed items (their buffers are zero-filled).
int pio_decode_batch(const char** rgb_paths, const char** depth_paths,
                     const char** seg_paths, const long* asset_ids, int n,
                     int h, int w, int n_threads, float* rgb_out,
                     float* depth_out, float* seg_out) {
  std::atomic<int> next(0), failures(0);
  int workers = n_threads > 0 ? n_threads : 1;
  if (workers > n) workers = n;

  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      float* rgb = rgb_out + static_cast<size_t>(i) * h * w * 3;
      float* dep = depth_out ? depth_out + static_cast<size_t>(i) * h * w : nullptr;
      float* seg = seg_out ? seg_out + static_cast<size_t>(i) * h * w : nullptr;
      bool ok = decode_example(rgb_paths[i], depth_paths ? depth_paths[i] : nullptr,
                               seg_paths ? seg_paths[i] : nullptr,
                               asset_ids ? asset_ids[i] : 0, h, w, rgb, dep, seg);
      if (!ok) {
        failures.fetch_add(1);
        std::memset(rgb, 0, sizeof(float) * h * w * 3);
        if (dep) std::memset(dep, 0, sizeof(float) * h * w);
        if (seg) std::memset(seg, 0, sizeof(float) * h * w);
      }
    }
  };

  std::vector<std::thread> pool;
  for (int t = 1; t < workers; ++t) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
