// Native COLMAP sparse-model parser (tpugs host runtime).
//
// The reference delegates COLMAP parsing to pycolmap_scene_manager
// (its utils.py:28-31, f3dgs/datasets/colmap.py:56-80), a
// compiled extension. tpugs's pure-Python reader (tpugs/io/colmap.py)
// is correct but loops per record; real SfM models carry millions of
// points3D and thousands of images, where Python-loop parsing costs
// tens of seconds per scene load. This module parses the binary
// format in C++ at memory-bandwidth speed and hands back flat columnar
// arrays (no per-record Python objects).
//
// Binary layout (COLMAP src/colmap/scene/reconstruction_io.cc):
//   points3D.bin: u64 n; per point: u64 id, 3 f64 xyz, 3 u8 rgb,
//                 f64 error, u64 track_len, track_len x (i32 image_id,
//                 i32 point2D_idx)
//   images.bin:   u64 n; per image: i32 id, 4 f64 qvec, 3 f64 tvec,
//                 i32 camera_id, name bytes + NUL, u64 n_obs,
//                 n_obs x (f64 x, f64 y, i64 point3D_id)
//
// All multi-byte values are little-endian; TPU hosts are x86/ARM LE so
// loads are plain memcpy (safe for unaligned access).
//
// API: two-pass. *_count scans the variable-length stream and returns
// totals so the caller (ctypes + numpy) can allocate exact-size
// buffers; *_parse fills them. Both return 0 on success, negative on a
// truncated/corrupt buffer.

#include <cstdint>
#include <cstring>

namespace {

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok;

  explicit Cursor(const uint8_t* buf, uint64_t len)
      : p(buf), end(buf + len), ok(true) {}

  template <typename T>
  T get() {
    T v{};
    if (p + sizeof(T) > end) {
      ok = false;
      return v;
    }
    std::memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    return v;
  }

  bool skip(uint64_t n) {
    if (p + n > end) {
      ok = false;
      return false;
    }
    p += n;
    return true;
  }

  // Length of the NUL-terminated string at the cursor (excl. NUL).
  int64_t cstr_len() const {
    const uint8_t* q = p;
    while (q < end && *q != 0) ++q;
    return q < end ? static_cast<int64_t>(q - p) : -1;
  }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------- points3D

int colmap_points3d_count(const uint8_t* buf, uint64_t len,
                          uint64_t* n_points, uint64_t* total_track) {
  Cursor c(buf, len);
  const uint64_t n = c.get<uint64_t>();
  uint64_t track_total = 0;
  for (uint64_t i = 0; i < n && c.ok; ++i) {
    // id + xyz + rgb + error = 8 + 24 + 3 + 8
    if (!c.skip(43)) return -1;
    const uint64_t t = c.get<uint64_t>();
    track_total += t;
    if (!c.skip(t * 8)) return -1;
  }
  if (!c.ok) return -1;
  *n_points = n;
  *total_track = track_total;
  return 0;
}

int colmap_points3d_parse(const uint8_t* buf, uint64_t len,
                          int64_t* pid, double* xyz, uint8_t* rgb,
                          double* err, int64_t* track_offsets,
                          int32_t* track_image_ids, int32_t* track_p2d) {
  Cursor c(buf, len);
  const uint64_t n = c.get<uint64_t>();
  uint64_t off = 0;
  for (uint64_t i = 0; i < n && c.ok; ++i) {
    pid[i] = static_cast<int64_t>(c.get<uint64_t>());
    xyz[3 * i + 0] = c.get<double>();
    xyz[3 * i + 1] = c.get<double>();
    xyz[3 * i + 2] = c.get<double>();
    rgb[3 * i + 0] = c.get<uint8_t>();
    rgb[3 * i + 1] = c.get<uint8_t>();
    rgb[3 * i + 2] = c.get<uint8_t>();
    err[i] = c.get<double>();
    const uint64_t t = c.get<uint64_t>();
    track_offsets[i] = static_cast<int64_t>(off);
    if (c.p + t * 8 > c.end) return -1;
    for (uint64_t j = 0; j < t; ++j) {
      std::memcpy(&track_image_ids[off + j], c.p + j * 8, 4);
      std::memcpy(&track_p2d[off + j], c.p + j * 8 + 4, 4);
    }
    c.p += t * 8;
    off += t;
  }
  if (!c.ok) return -1;
  track_offsets[n] = static_cast<int64_t>(off);
  return 0;
}

// ------------------------------------------------------------ images

int colmap_images_count(const uint8_t* buf, uint64_t len,
                        uint64_t* n_images, uint64_t* total_obs,
                        uint64_t* total_name_bytes) {
  Cursor c(buf, len);
  const uint64_t n = c.get<uint64_t>();
  uint64_t obs_total = 0, name_total = 0;
  for (uint64_t i = 0; i < n && c.ok; ++i) {
    // id(i32) + qvec(4 f64) + tvec(3 f64) + camera_id(i32)
    if (!c.skip(4 + 32 + 24 + 4)) return -1;
    const int64_t name_len = c.cstr_len();
    if (name_len < 0) return -1;
    name_total += static_cast<uint64_t>(name_len);
    if (!c.skip(static_cast<uint64_t>(name_len) + 1)) return -1;
    const uint64_t m = c.get<uint64_t>();
    obs_total += m;
    if (!c.skip(m * 24)) return -1;
  }
  if (!c.ok) return -1;
  *n_images = n;
  *total_obs = obs_total;
  *total_name_bytes = name_total;
  return 0;
}

int colmap_images_parse(const uint8_t* buf, uint64_t len,
                        int32_t* image_id, double* qvec, double* tvec,
                        int32_t* camera_id, char* names,
                        int64_t* name_offsets, int64_t* obs_offsets,
                        double* xys, int64_t* p3d_ids) {
  Cursor c(buf, len);
  const uint64_t n = c.get<uint64_t>();
  uint64_t obs_off = 0, name_off = 0;
  for (uint64_t i = 0; i < n && c.ok; ++i) {
    image_id[i] = c.get<int32_t>();
    for (int k = 0; k < 4; ++k) qvec[4 * i + k] = c.get<double>();
    for (int k = 0; k < 3; ++k) tvec[3 * i + k] = c.get<double>();
    camera_id[i] = c.get<int32_t>();
    const int64_t name_len = c.cstr_len();
    if (name_len < 0) return -1;
    std::memcpy(names + name_off, c.p, static_cast<size_t>(name_len));
    name_offsets[i] = static_cast<int64_t>(name_off);
    name_off += static_cast<uint64_t>(name_len);
    c.skip(static_cast<uint64_t>(name_len) + 1);
    const uint64_t m = c.get<uint64_t>();
    obs_offsets[i] = static_cast<int64_t>(obs_off);
    if (c.p + m * 24 > c.end) return -1;
    for (uint64_t j = 0; j < m; ++j) {
      std::memcpy(&xys[2 * (obs_off + j)], c.p + j * 24, 16);
      std::memcpy(&p3d_ids[obs_off + j], c.p + j * 24 + 16, 8);
    }
    c.p += m * 24;
    obs_off += m;
  }
  if (!c.ok) return -1;
  name_offsets[n] = static_cast<int64_t>(name_off);
  obs_offsets[n] = static_cast<int64_t>(obs_off);
  return 0;
}

// ----------------------------------------------------------- writers
// Serialize columnar arrays straight to the COLMAP binary layout —
// the inverse of the parsers, used by the synthetic dataset writer
// (scripts/make_atscale_dataset.py) where the Python struct.pack loop
// dominates build time at millions of points.

// Exact output size so the caller can allocate one buffer.
uint64_t colmap_points3d_size(uint64_t n, uint64_t total_track) {
  return 8 + n * 51 + total_track * 8;
}

int colmap_points3d_write(uint64_t n, const int64_t* pid, const double* xyz,
                          const uint8_t* rgb, const double* err,
                          const int64_t* track_offsets,
                          const int32_t* track_image_ids,
                          const int32_t* track_p2d, uint8_t* out) {
  uint8_t* p = out;
  std::memcpy(p, &n, 8);
  p += 8;
  for (uint64_t i = 0; i < n; ++i) {
    std::memcpy(p, &pid[i], 8);
    p += 8;
    std::memcpy(p, &xyz[3 * i], 24);
    p += 24;
    std::memcpy(p, &rgb[3 * i], 3);
    p += 3;
    std::memcpy(p, &err[i], 8);
    p += 8;
    const uint64_t t =
        static_cast<uint64_t>(track_offsets[i + 1] - track_offsets[i]);
    std::memcpy(p, &t, 8);
    p += 8;
    for (uint64_t j = 0; j < t; ++j) {
      std::memcpy(p, &track_image_ids[track_offsets[i] + j], 4);
      std::memcpy(p + 4, &track_p2d[track_offsets[i] + j], 4);
      p += 8;
    }
  }
  return 0;
}

}  // extern "C"
