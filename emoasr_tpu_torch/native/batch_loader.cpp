// Native feature batch loader: N .npy files -> one padded (B, T, F) buffer.
//
// The reference's data path loads .npy per-utterance in Python DataLoader
// worker processes (emoASR asr/datasets.py:87-101).  The host
// keeps a single fast process feeding the device; this loader
// parses the npy headers and copies rows into the caller's preallocated
// float32 buffer with a std::thread pool, so batch assembly costs ~memcpy.
//
// Supports the npy v1/v2 format for little-endian float32/float64 C-order
// 2-D arrays (what corpora/prep.py writes).  C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Header {
  int64_t rows = 0, cols = 0;
  int64_t data_offset = 0;
  bool f64 = false;
  bool ok = false;
};

Header parse_npy_header(FILE* f) {
  Header h;
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return h;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return h;
  const int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return h;
    header_len = b[0] | (b[1] << 8);
    h.data_offset = 10 + header_len;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return h;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
    h.data_offset = 12 + header_len;
  }
  std::string hdr(header_len, '\0');
  if (fread(&hdr[0], 1, header_len, f) != header_len) return h;

  if (hdr.find("'<f4'") != std::string::npos) {
    h.f64 = false;
  } else if (hdr.find("'<f8'") != std::string::npos) {
    h.f64 = true;
  } else {
    return h;  // unsupported dtype
  }
  if (hdr.find("'fortran_order': True") != std::string::npos) return h;

  const auto sp = hdr.find("'shape':");
  const auto lp = hdr.find('(', sp);
  const auto rp = hdr.find(')', lp);
  if (sp == std::string::npos || lp == std::string::npos) return h;
  std::string shape = hdr.substr(lp + 1, rp - lp - 1);
  long long rows = 0, cols = 1;
  if (sscanf(shape.c_str(), "%lld, %lld", &rows, &cols) < 1) return h;
  h.rows = rows;
  h.cols = cols;
  h.ok = true;
  return h;
}

// Load one file into out (max_rows, out_cols), returns rows copied or -1.
int64_t load_one(const char* path, float* out, int64_t max_rows,
                 int64_t out_cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Header h = parse_npy_header(f);
  if (!h.ok || h.cols < out_cols) {
    fclose(f);
    return -1;
  }
  const int64_t rows = std::min<int64_t>(h.rows, max_rows);
  if (fseek(f, static_cast<long>(h.data_offset), SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }
  if (!h.f64 && h.cols == out_cols) {
    const size_t want = static_cast<size_t>(rows * out_cols);
    if (fread(out, sizeof(float), want, f) != want) {
      fclose(f);
      return -1;
    }
  } else {
    // row-by-row (wider source or float64)
    const size_t elem = h.f64 ? 8 : 4;
    std::vector<unsigned char> rowbuf(h.cols * elem);
    for (int64_t r = 0; r < rows; ++r) {
      if (fread(rowbuf.data(), elem, h.cols, f) != (size_t)h.cols) {
        fclose(f);
        return -1;
      }
      float* dst = out + r * out_cols;
      if (h.f64) {
        const double* src = reinterpret_cast<const double*>(rowbuf.data());
        for (int64_t c = 0; c < out_cols; ++c) dst[c] = (float)src[c];
      } else {
        memcpy(dst, rowbuf.data(), out_cols * 4);
      }
    }
  }
  fclose(f);
  return rows;
}

}  // namespace

extern "C" {

// paths: B concatenated NUL-terminated strings.
// out: preallocated zeroed (B, max_rows, cols) float32.
// out_lens: (B,) rows actually copied (-1 on per-file failure).
void load_feat_batch(const char* paths, int64_t batch, float* out,
                     int64_t max_rows, int64_t cols, int64_t* out_lens,
                     int32_t num_threads) {
  std::vector<const char*> ptrs(batch);
  const char* p = paths;
  for (int64_t i = 0; i < batch; ++i) {
    ptrs[i] = p;
    p += strlen(p) + 1;
  }
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      out_lens[i] =
          load_one(ptrs[i], out + i * max_rows * cols, max_rows, cols);
    }
  };
  if (num_threads < 1) num_threads = 1;
  if (num_threads == 1 || batch < 2) {
    work(0, batch);
    return;
  }
  std::vector<std::thread> pool;
  const int64_t chunk = (batch + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min<int64_t>(batch, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(work, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
