// Native host runtime for raytracer_tpu.
//
// The device compute path is JAX/XLA; the host-side runtime around it — sRGB
// encoding, crash-safe PNG export, tone-normalization statistics — is native
// C++, filling the role the reference's Rust binary plays off the hot path
// (reference: src/image.rs color conversion, src/main.rs:748-776 post
// process + atomic PNG write).  Bound from Python via ctypes
// (raytracer_tpu/utils/native.py); every entry point has a pure-Python
// fallback the tests compare against.

#include <algorithm>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

extern "C" {

// Linear [0,1] float -> sRGB-encoded u8, round-to-nearest.  Same transfer
// function as palette's Srgb encoding used by the reference PNG writer.
void rt_srgb_encode_u8(const float* linear, uint8_t* out, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    float x = linear[i];
    if (!(x > 0.0f)) x = 0.0f;  // clamps NaN too
    if (x > 1.0f) x = 1.0f;
    float enc = (x <= 0.0031308f) ? 12.92f * x
                                  : 1.055f * std::pow(x, 1.0f / 2.4f) - 0.055f;
    out[i] = static_cast<uint8_t>(std::lround(enc * 255.0f));
  }
}

namespace {

void put_be32(std::string* s, uint32_t v) {
  char b[4] = {static_cast<char>(v >> 24), static_cast<char>(v >> 16),
               static_cast<char>(v >> 8), static_cast<char>(v)};
  s->append(b, 4);
}

void put_chunk(std::string* s, const char tag[4], const std::string& payload) {
  put_be32(s, static_cast<uint32_t>(payload.size()));
  std::string body(tag, 4);
  body += payload;
  s->append(body);
  uint32_t crc = crc32(0L, reinterpret_cast<const Bytef*>(body.data()),
                       static_cast<uInt>(body.size()));
  put_be32(s, crc);
}

}  // namespace

// Encode [h, w, 3] u8 as PNG (color type 2, filter 0, zlib level 1 —
// this encoder runs once per progressive epoch on a single host core, so
// encode speed beats a few percent of file size) and write it to
// `path` via tmp-file + atomic rename, mirroring the reference's crash-safe
// progressive output (src/main.rs:764-776).  Returns 0 on success.
int rt_write_png_atomic(const char* path, const uint8_t* rgb, uint32_t w,
                        uint32_t h) {
  const size_t stride = static_cast<size_t>(w) * 3;
  std::vector<uint8_t> raw((stride + 1) * h);
  for (uint32_t y = 0; y < h; ++y) {
    raw[y * (stride + 1)] = 0;  // filter: None
    std::memcpy(&raw[y * (stride + 1) + 1], rgb + y * stride, stride);
  }

  uLongf bound = compressBound(static_cast<uLong>(raw.size()));
  std::vector<uint8_t> compressed(bound);
  if (compress2(compressed.data(), &bound, raw.data(),
                static_cast<uLong>(raw.size()), 1) != Z_OK) {
    return 1;
  }

  std::string png("\x89PNG\r\n\x1a\n", 8);
  std::string ihdr;
  put_be32(&ihdr, w);
  put_be32(&ihdr, h);
  const char rest[5] = {8, 2, 0, 0, 0};
  ihdr.append(rest, 5);
  put_chunk(&png, "IHDR", ihdr);
  put_chunk(&png, "IDAT",
            std::string(reinterpret_cast<char*>(compressed.data()), bound));
  put_chunk(&png, "IEND", "");

  std::string tmp(path);
  size_t slash = tmp.find_last_of('/');
  std::string dir = (slash == std::string::npos) ? "" : tmp.substr(0, slash + 1);
  std::string base = (slash == std::string::npos) ? tmp : tmp.substr(slash + 1);
  std::string tmp_path = dir + "." + base + ".tmp";

  FILE* f = std::fopen(tmp_path.c_str(), "wb");
  if (!f) return 2;
  size_t written = std::fwrite(png.data(), 1, png.size(), f);
  if (std::fflush(f) != 0 || written != png.size()) {
    std::fclose(f);
    std::remove(tmp_path.c_str());
    return 3;
  }
  std::fclose(f);
  if (std::rename(tmp_path.c_str(), path) != 0) {
    std::remove(tmp_path.c_str());
    return 4;
  }
  return 0;
}

// Percentile of per-pixel luma with Rust f32::is_normal() filtering — the
// reference tone normalizer's statistic (src/main.rs:748-762): sort
// ascending, index floor(count * q).  Returns 0 when no lane is normal.
float rt_luma_percentile(const float* rgb, size_t n_pixels, float q) {
  std::vector<float> lumas;
  lumas.reserve(n_pixels);
  for (size_t i = 0; i < n_pixels; ++i) {
    float l = 0.212656f * rgb[3 * i] + 0.715158f * rgb[3 * i + 1] +
              0.072186f * rgb[3 * i + 2];
    if (std::isfinite(l) && std::fpclassify(l) == FP_NORMAL) {
      lumas.push_back(l);
    }
  }
  if (lumas.empty()) return 0.0f;
  size_t idx = static_cast<size_t>(static_cast<float>(lumas.size()) * q);
  if (idx >= lumas.size()) idx = lumas.size() - 1;
  std::nth_element(lumas.begin(), lumas.begin() + idx, lumas.end());
  return lumas[idx];
}

}  // extern "C"
