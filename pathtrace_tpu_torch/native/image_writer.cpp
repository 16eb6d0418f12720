// Native image writers — the role of src/image.cpp + stb_image_write:
// PNG (zlib deflate, filter 0) and Radiance HDR (flat RGBE), with the
// reference's save conventions applied by the Python layer
// (accum/samples, x-mirror, clamp -> u8; src/main.cpp:49-70,
// src/image.cpp:22-45).

#include <zlib.h>

#include <cmath>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

void put_u32_be(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back((x >> 24) & 0xff);
  v.push_back((x >> 16) & 0xff);
  v.push_back((x >> 8) & 0xff);
  v.push_back(x & 0xff);
}

void put_chunk(std::vector<uint8_t>& out, const char type[4],
               const uint8_t* data, size_t len) {
  put_u32_be(out, (uint32_t)len);
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  out.insert(out.end(), data, data + len);
  uLong crc = crc32(0L, out.data() + start, (uInt)(len + 4));
  put_u32_be(out, (uint32_t)crc);
}

}  // namespace

extern "C" {

// rgb: row-major (h, w, 3) uint8.  Returns 0 on success.
int pt_write_png(const char* path, int32_t w, int32_t h,
                 const uint8_t* rgb) {
  // raw scanlines with filter byte 0
  std::vector<uint8_t> raw((size_t)h * (w * 3 + 1));
  for (int y = 0; y < h; ++y) {
    uint8_t* row = raw.data() + (size_t)y * (w * 3 + 1);
    row[0] = 0;
    std::memcpy(row + 1, rgb + (size_t)y * w * 3, (size_t)w * 3);
  }
  uLongf zcap = compressBound((uLong)raw.size());
  std::vector<uint8_t> z(zcap);
  if (compress2(z.data(), &zcap, raw.data(), (uLong)raw.size(), 6) != Z_OK)
    return 1;
  z.resize(zcap);

  std::vector<uint8_t> out;
  const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = (w >> 24) & 0xff; ihdr[1] = (w >> 16) & 0xff;
  ihdr[2] = (w >> 8) & 0xff;  ihdr[3] = w & 0xff;
  ihdr[4] = (h >> 24) & 0xff; ihdr[5] = (h >> 16) & 0xff;
  ihdr[6] = (h >> 8) & 0xff;  ihdr[7] = h & 0xff;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type RGB
  ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);
  put_chunk(out, "IDAT", z.data(), z.size());
  put_chunk(out, "IEND", nullptr, 0);

  FILE* f = std::fopen(path, "wb");
  if (!f) return 2;
  size_t n = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return n == out.size() ? 0 : 3;
}

// img: row-major (h, w, 3) float32 (linear radiance). Radiance RGBE,
// flat runs (matches pathtrace_tpu_torch.io.image_io.save_hdr).
int pt_write_hdr(const char* path, int32_t w, int32_t h, const float* img) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 2;
  std::fprintf(f, "#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n");
  std::fprintf(f, "-Y %d +X %d\n", h, w);
  std::vector<uint8_t> row((size_t)w * 4);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const float* p = img + ((size_t)y * w + x) * 3;
      float m = p[0] > p[1] ? p[0] : p[1];
      if (p[2] > m) m = p[2];
      uint8_t* o = row.data() + (size_t)x * 4;
      if (m < 1e-32f) {
        o[0] = o[1] = o[2] = o[3] = 0;
      } else {
        int e;
        float mant = std::frexp(m, &e);
        float scale = mant * 256.0f / m;
        float r0 = p[0] * scale, g0 = p[1] * scale, b0 = p[2] * scale;
        o[0] = (uint8_t)(r0 < 0 ? 0 : (r0 > 255 ? 255 : r0));
        o[1] = (uint8_t)(g0 < 0 ? 0 : (g0 > 255 ? 255 : g0));
        o[2] = (uint8_t)(b0 < 0 ? 0 : (b0 > 255 ? 255 : b0));
        o[3] = (uint8_t)(e + 128);
      }
    }
    std::fwrite(row.data(), 1, row.size(), f);
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
