// lvt_io — native data-loading kernels for the host input pipeline.
//
// The reference framework is pure Python (SURVEY.md §1: no csrc/); its input
// pipeline cost is hidden in torch DataLoader worker processes. Our loaders
// are thread-based, so the per-sample decode cost is on the critical path —
// these C++ kernels remove the Python/PIL overhead for the two hot formats:
//
//   * decode_png_rgb: minimal PNG decoder (8-bit, color types 0/2/3/6,
//     non-interlaced — everything convert_bair/convert_kinetics produce)
//     via zlib inflate + per-scanline unfiltering.
//   * load_npy_i32_sequence: reads a video's N .npy latent-code files into
//     one contiguous int32 buffer (the DSFVT training sample) without
//     N numpy allocations.
//
// Exposed through ctypes (see native/__init__.py); falls back to PIL/numpy
// when the shared library is unavailable.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <zlib.h>

extern "C" {

static uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

static int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode an in-memory PNG to tightly packed RGB8.
// Returns 0 on success; fills *w/*h. `out` must hold w*h*3 bytes
// (call with out=nullptr first to query dimensions via header parse).
int decode_png_rgb(const uint8_t* data, long len, uint8_t* out, int* out_w,
                   int* out_h) {
  if (len < 8 || memcmp(data, "\x89PNG\r\n\x1a\n", 8) != 0) return -1;
  long pos = 8;
  int w = 0, h = 0, bit_depth = 0, color_type = -1;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;  // color type 3

  while (pos + 8 <= len) {
    uint32_t clen = be32(data + pos);
    const uint8_t* ctype = data + pos + 4;
    const uint8_t* cdata = data + pos + 8;
    if (pos + 12 + (long)clen > len) return -2;
    if (!memcmp(ctype, "IHDR", 4)) {
      if (clen < 13) return -3;  // truncated IHDR: fields below would read OOB
      w = be32(cdata);
      h = be32(cdata + 4);
      bit_depth = cdata[8];
      color_type = cdata[9];
      if (cdata[12] != 0) return -3;  // interlaced unsupported
      if (bit_depth != 8) return -4;
    } else if (!memcmp(ctype, "PLTE", 4)) {
      palette.assign(cdata, cdata + clen);
    } else if (!memcmp(ctype, "IDAT", 4)) {
      idat.insert(idat.end(), cdata, cdata + clen);
    } else if (!memcmp(ctype, "IEND", 4)) {
      break;
    }
    pos += 12 + clen;
  }
  if (w <= 0 || h <= 0) return -5;
  *out_w = w;
  *out_h = h;
  if (out == nullptr) return 0;  // dimension query

  int ch;  // input channels per pixel
  switch (color_type) {
    case 0: ch = 1; break;  // gray
    case 2: ch = 3; break;  // rgb
    case 3: ch = 1; break;  // palette
    case 4: ch = 2; break;  // gray+alpha
    case 6: ch = 4; break;  // rgba
    default: return -6;
  }

  const long stride = (long)w * ch;
  std::vector<uint8_t> raw((stride + 1) * (long)h);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    return -7;

  std::vector<uint8_t> prev(stride, 0);
  std::vector<uint8_t> cur(stride);
  for (int y = 0; y < h; ++y) {
    const uint8_t* line = raw.data() + (long)y * (stride + 1);
    int filter = line[0];
    const uint8_t* src = line + 1;
    for (long x = 0; x < stride; ++x) {
      int a = x >= ch ? cur[x - ch] : 0;
      int b = prev[x];
      int c = x >= ch ? prev[x - ch] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return -8;
      }
      cur[x] = (uint8_t)v;
    }
    // expand to RGB
    uint8_t* dst = out + (long)y * w * 3;
    for (int x = 0; x < w; ++x) {
      const uint8_t* px = cur.data() + (long)x * ch;
      switch (color_type) {
        case 0:
        case 4: dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = px[0]; break;
        case 2:
        case 6:
          dst[3 * x] = px[0];
          dst[3 * x + 1] = px[1];
          dst[3 * x + 2] = px[2];
          break;
        case 3: {
          if ((size_t)(px[0] * 3 + 2) >= palette.size()) return -9;
          dst[3 * x] = palette[px[0] * 3];
          dst[3 * x + 1] = palette[px[0] * 3 + 1];
          dst[3 * x + 2] = palette[px[0] * 3 + 2];
          break;
        }
      }
    }
    prev.swap(cur);
  }
  return 0;
}

// Read a whole PNG file and decode; convenience for ctypes callers.
// out == nullptr is a DIMS-ONLY query: reads just the 33 header bytes
// (signature + IHDR) instead of the whole file — the Python wrapper calls
// query-then-decode per frame, so the query must not double the file IO.
int decode_png_file_rgb(const char* path, uint8_t* out, long out_cap,
                        int* out_w, int* out_h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  if (out == nullptr) {
    uint8_t head[33];
    size_t n = fread(head, 1, sizeof(head), f);
    fclose(f);
    if (n < sizeof(head) || memcmp(head, "\x89PNG\r\n\x1a\n", 8) != 0)
      return -1;
    if (memcmp(head + 12, "IHDR", 4) != 0) return -2;  // IHDR must be first
    if (be32(head + 8) < 13) return -3;
    *out_w = (int)be32(head + 16);
    *out_h = (int)be32(head + 20);
    if (head[24] != 8) return -4;   // bit depth
    if (head[28] != 0) return -3;   // interlaced unsupported
    if (*out_w <= 0 || *out_h <= 0) return -5;
    return 0;
  }
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (len <= 0) {  // ftell failure (-1) would otherwise wrap to a huge
    fclose(f);     // vector size and throw across the extern "C" boundary
    return -11;
  }
  std::vector<uint8_t> buf(len);
  if (fread(buf.data(), 1, len, f) != (size_t)len) {
    fclose(f);
    return -11;
  }
  fclose(f);
  int rc = decode_png_rgb(buf.data(), len, nullptr, out_w, out_h);
  if (rc != 0) return rc;
  if ((long)(*out_w) * (*out_h) * 3 > out_cap) return -12;
  return decode_png_rgb(buf.data(), len, out, out_w, out_h);
}

// Parse one .npy (v1/v2, little-endian int32/int64, C order) and append its
// elements as int32 into out. Returns number of elements, or negative error.
static long load_npy_i32(const char* path, int32_t* out, long out_cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t magic[8];
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, "\x93NUMPY", 6) != 0) {
    fclose(f);
    return -2;
  }
  int major = magic[6];
  uint32_t hlen = 0;
  if (major == 1) {
    uint8_t b[2];
    if (fread(b, 1, 2, f) != 2) { fclose(f); return -3; }
    hlen = b[0] | (b[1] << 8);
  } else {
    uint8_t b[4];
    if (fread(b, 1, 4, f) != 4) { fclose(f); return -3; }
    hlen = b[0] | (b[1] << 8) | (b[2] << 16) | (uint32_t(b[3]) << 24);
  }
  std::vector<char> header(hlen + 1, 0);
  if (fread(header.data(), 1, hlen, f) != hlen) { fclose(f); return -4; }

  const char* descr = strstr(header.data(), "'descr':");
  bool is_i8 = descr && strstr(descr, "<i8");
  bool is_i4 = descr && strstr(descr, "<i4");
  if (!is_i8 && !is_i4) { fclose(f); return -5; }
  if (strstr(header.data(), "'fortran_order': True")) { fclose(f); return -6; }

  const char* shp = strstr(header.data(), "'shape':");
  if (!shp) { fclose(f); return -7; }
  long count = 1;
  const char* p = strchr(shp, '(');
  if (!p) { fclose(f); return -7; }
  ++p;
  while (*p && *p != ')') {
    while (*p == ' ' || *p == ',') ++p;
    if (*p == ')') break;
    long dim = strtol(p, (char**)&p, 10);
    if (dim > 0) count *= dim;
  }
  if (count > out_cap) { fclose(f); return -8; }

  if (is_i4) {
    if (fread(out, 4, count, f) != (size_t)count) { fclose(f); return -9; }
  } else {
    std::vector<int64_t> tmp(count);
    if (fread(tmp.data(), 8, count, f) != (size_t)count) { fclose(f); return -9; }
    for (long i = 0; i < count; ++i) out[i] = (int32_t)tmp[i];
  }
  fclose(f);
  return count;
}

// Load n npy files (newline-joined paths) into one contiguous int32 buffer.
// Every file must hold the same element count; returns per-file count, or
// negative error.
long load_npy_i32_sequence(const char* joined_paths, int n, int32_t* out,
                           long out_cap) {
  const char* p = joined_paths;
  long per = -1;
  for (int i = 0; i < n; ++i) {
    const char* end = strchr(p, '\n');
    size_t plen = end ? (size_t)(end - p) : strlen(p);
    std::vector<char> path(p, p + plen);
    path.push_back(0);
    long cnt = load_npy_i32(path.data(), out, out_cap);
    if (cnt < 0) return cnt * 100 - i;
    if (per == -1) per = cnt;
    if (cnt != per) return -90;
    out += cnt;
    out_cap -= cnt;
    p = end ? end + 1 : p + plen;
  }
  return per;
}

}  // extern "C"
