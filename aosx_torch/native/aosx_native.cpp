// Native host runtime of aosx_torch (C++17, built as a shared library by g++
// at first use, bound with ctypes - see binding.py). A copy of
// aosx/native/aosx_native.cpp, whose functions it keeps unchanged:
//   - aosx_load_pcd_xyz : fast binary PCD v0.7 reader for map replay
//                         (offline maps are LIO-SAM .pcd dumps)
//   - aosx_thin         : Zhang-Suen thinning to fixpoint (bit-identical to
//                         the JAX package's Python oracle)
//   - aosx_label        : 8-connected components by BFS in raster discovery
//                         order

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PCD reader: binary v0.7, extracts x/y/z fields. Returns the number of
// points written to out (3*N floats), or -1 on error.
// ---------------------------------------------------------------------------
long aosx_load_pcd_xyz(const char* path, float* out, long max_points) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;

  char line[1024];
  long n_points = 0;
  std::vector<std::string> fields;
  std::vector<int> sizes, counts;
  std::vector<std::string> types;
  std::string data_kind;

  while (std::fgets(line, sizeof(line), f)) {
    std::string s(line);
    while (!s.empty() && (s.back() == '\n' || s.back() == '\r')) s.pop_back();
    if (s.empty() || s[0] == '#') continue;
    auto sp = s.find(' ');
    std::string key = s.substr(0, sp);
    std::string val = (sp == std::string::npos) ? "" : s.substr(sp + 1);
    auto split = [](const std::string& v) {
      std::vector<std::string> out;
      size_t i = 0;
      while (i < v.size()) {
        size_t j = v.find(' ', i);
        if (j == std::string::npos) j = v.size();
        if (j > i) out.push_back(v.substr(i, j - i));
        i = j + 1;
      }
      return out;
    };
    if (key == "FIELDS") {
      fields = split(val);
    } else if (key == "SIZE") {
      for (auto& t : split(val)) sizes.push_back(std::stoi(t));
    } else if (key == "TYPE") {
      types = split(val);
    } else if (key == "COUNT") {
      for (auto& t : split(val)) counts.push_back(std::stoi(t));
    } else if (key == "POINTS") {
      n_points = std::stol(val);
    } else if (key == "DATA") {
      data_kind = val;
      break;
    }
  }
  if (data_kind != "binary" || fields.empty() || sizes.size() != fields.size()) {
    std::fclose(f);
    return -1;
  }
  if (counts.empty()) counts.assign(fields.size(), 1);
  // COUNT/TYPE rows (when present) must cover every field, or the offset
  // computation below would read out of bounds / misparse
  if (counts.size() != fields.size() ||
      (!types.empty() && types.size() != fields.size())) {
    std::fclose(f);
    return -1;
  }

  int stride = 0, off_x = -1, off_y = -1, off_z = -1;
  bool xyz_f32 = true;
  for (size_t i = 0; i < fields.size(); ++i) {
    if (fields[i] == "x" || fields[i] == "y" || fields[i] == "z") {
      // the memcpy below assumes 4-byte IEEE floats; reject f64/int coords
      // (the Python parser handles those dtypes correctly instead)
      if (sizes[i] != 4 || (!types.empty() && types[i] != "F")) xyz_f32 = false;
      if (fields[i] == "x") off_x = stride;
      if (fields[i] == "y") off_y = stride;
      if (fields[i] == "z") off_z = stride;
    }
    stride += sizes[i] * counts[i];
  }
  if (off_x < 0 || off_y < 0 || off_z < 0 || !xyz_f32) {
    std::fclose(f);
    return -1;
  }
  long n = n_points < max_points ? n_points : max_points;
  std::vector<char> buf(static_cast<size_t>(stride) * n);
  size_t got = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  long n_ok = static_cast<long>(got / stride);
  if (n_ok < n) n = n_ok;
  for (long i = 0; i < n; ++i) {
    const char* p = buf.data() + static_cast<size_t>(i) * stride;
    std::memcpy(out + 3 * i + 0, p + off_x, 4);
    std::memcpy(out + 3 * i + 1, p + off_y, 4);
    std::memcpy(out + 3 * i + 2, p + off_z, 4);
  }
  return n;
}

// ---------------------------------------------------------------------------
// Zhang-Suen thinning to fixpoint on a {0,1} uint8 image. In-place.
// Border ring untouched; both sub-iterations per outer round; stops when
// unchanged. Returns the number of outer rounds.
// ---------------------------------------------------------------------------
static int subiter(uint8_t* img, uint8_t* mark, int h, int w, int phase) {
  int changed = 0;
  for (int y = 1; y < h - 1; ++y) {
    for (int x = 1; x < w - 1; ++x) {
      const long i = static_cast<long>(y) * w + x;
      if (!img[i]) {
        mark[i] = 0;
        continue;
      }
      const uint8_t p2 = img[i - w], p3 = img[i - w + 1], p4 = img[i + 1];
      const uint8_t p5 = img[i + w + 1], p6 = img[i + w], p7 = img[i + w - 1];
      const uint8_t p8 = img[i - 1], p9 = img[i - w - 1];
      const int B = p2 + p3 + p4 + p5 + p6 + p7 + p8 + p9;
      const int A = (p2 == 0 && p3 == 1) + (p3 == 0 && p4 == 1) +
                    (p4 == 0 && p5 == 1) + (p5 == 0 && p6 == 1) +
                    (p6 == 0 && p7 == 1) + (p7 == 0 && p8 == 1) +
                    (p8 == 0 && p9 == 1) + (p9 == 0 && p2 == 1);
      const int m1 = phase == 0 ? (p2 * p4 * p6) : (p2 * p4 * p8);
      const int m2 = phase == 0 ? (p4 * p6 * p8) : (p2 * p6 * p8);
      mark[i] = (A == 1 && B >= 2 && B <= 6 && m1 == 0 && m2 == 0) ? 1 : 0;
      changed |= mark[i];
    }
  }
  if (changed) {
    for (int y = 1; y < h - 1; ++y)
      for (int x = 1; x < w - 1; ++x) {
        const long i = static_cast<long>(y) * w + x;
        if (mark[i]) img[i] = 0;
      }
  }
  return changed;
}

int aosx_thin(uint8_t* img, int h, int w, int max_iters) {
  std::vector<uint8_t> mark(static_cast<size_t>(h) * w, 0);
  int it = 0;
  for (; it < max_iters; ++it) {
    int c0 = subiter(img, mark.data(), h, w, 0);
    int c1 = subiter(img, mark.data(), h, w, 1);
    if (!c0 && !c1) break;
  }
  return it;
}

// ---------------------------------------------------------------------------
// 8-connected components of mask (uint8 {0,1}) in raster discovery order.
// labels: int32 out (-1 background). Returns component count.
// ---------------------------------------------------------------------------
int aosx_label(const uint8_t* mask, int32_t* labels, int h, int w) {
  const long n = static_cast<long>(h) * w;
  for (long i = 0; i < n; ++i) labels[i] = -1;
  std::vector<long> queue;
  int next = 0;
  for (long start = 0; start < n; ++start) {
    if (!mask[start] || labels[start] >= 0) continue;
    queue.clear();
    queue.push_back(start);
    labels[start] = next;
    size_t head = 0;
    while (head < queue.size()) {
      const long cur = queue[head++];
      const int cy = static_cast<int>(cur / w);
      const int cx = static_cast<int>(cur % w);
      for (int dy = -1; dy <= 1; ++dy) {
        for (int dx = -1; dx <= 1; ++dx) {
          if (!dy && !dx) continue;
          const int ny = cy + dy, nx = cx + dx;
          if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
          const long ni = static_cast<long>(ny) * w + nx;
          if (mask[ni] && labels[ni] < 0) {
            labels[ni] = next;
            queue.push_back(ni);
          }
        }
      }
    }
    ++next;
  }
  return next;
}

}  // extern "C"
