// TRR trajectory I/O — native XDR encoder/decoder.
//
// The reference implements trajectory I/O in C (src/gromacs/fileio/
// trrio.cpp over XDR); this is an independent implementation of the same
// wire format (GMX_trn_file magic 1993, big-endian XDR scalars, f32
// coordinate payloads) so trajectories interoperate with GROMACS tools.
//
// Built as a shared library and driven from Python via ctypes — the IO
// hot loop (byte swapping + buffered writes) stays native.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t kMagic = 1993;
constexpr const char* kVersion = "GMX_trn_file";

inline uint32_t bswap32(uint32_t v) {
#if defined(__GNUC__)
  return __builtin_bswap32(v);
#else
  return ((v & 0xFF) << 24) | ((v & 0xFF00) << 8) | ((v >> 8) & 0xFF00) |
         ((v >> 24) & 0xFF);
#endif
}

inline bool host_is_little_endian() {
  const uint32_t one = 1;
  return *reinterpret_cast<const uint8_t*>(&one) == 1;
}

inline uint32_t to_be(uint32_t v) {
  return host_is_little_endian() ? bswap32(v) : v;
}

struct Writer {
  FILE* f;
  bool ok = true;
  void u32(uint32_t v) {
    v = to_be(v);
    ok &= fwrite(&v, 4, 1, f) == 1;
  }
  void i32(int32_t v) { u32(static_cast<uint32_t>(v)); }
  void f32(float v) {
    uint32_t u;
    memcpy(&u, &v, 4);
    u32(u);
  }
  void xdr_string(const char* s) {
    // GROMACS (gmxfio_xdr.cpp gmx_fio_do_string) writes an outer int
    // slen = strlen+1, then libc xdr_string which itself emits
    // u32(strlen) + the unpadded bytes padded to a 4-byte boundary.
    int32_t len = static_cast<int32_t>(strlen(s));
    i32(len + 1);
    u32(static_cast<uint32_t>(len));
    size_t pad = (4 - (len % 4)) % 4;
    ok &= fwrite(s, 1, len, f) == static_cast<size_t>(len);
    const char zeros[4] = {0, 0, 0, 0};
    if (pad) ok &= fwrite(zeros, 1, pad, f) == pad;
  }
  void f32_array_swapped(const float* data, size_t n) {
    std::vector<uint32_t> buf(n);
    memcpy(buf.data(), data, n * 4);
    if (host_is_little_endian())
      for (size_t i = 0; i < n; ++i) buf[i] = bswap32(buf[i]);
    ok &= fwrite(buf.data(), 4, n, f) == n;
  }
};

struct Reader {
  FILE* f;
  bool ok = true;
  uint32_t u32() {
    uint32_t v = 0;
    ok &= fread(&v, 4, 1, f) == 1;
    return to_be(v);
  }
  int32_t i32() { return static_cast<int32_t>(u32()); }
  float f32() {
    uint32_t u = u32();
    float v;
    memcpy(&v, &u, 4);
    return v;
  }
  void skip_string() {
    (void)i32();  // outer slen = strlen+1 (gmx_fio_do_string)
    int32_t len = i32();  // xdr_string's own length word
    size_t pad = (4 - (len % 4)) % 4;
    ok &= fseek(f, len + pad, SEEK_CUR) == 0;
  }
  void f32_array_swapped(float* out, size_t n) {
    std::vector<uint32_t> buf(n);
    ok &= fread(buf.data(), 4, n, f) == n;
    if (host_is_little_endian())
      for (size_t i = 0; i < n; ++i) buf[i] = bswap32(buf[i]);
    memcpy(out, buf.data(), n * 4);
  }
};

}  // namespace

extern "C" {

// Appends one frame.  x/v/f may be null (size 0 in the header).
// Returns 0 on success.
int trr_write_frame(const char* path, int natoms, int step, float time,
                    float lambda, const float* box9, const float* x,
                    const float* v, const float* frc) {
  FILE* fp = fopen(path, "ab");
  if (!fp) return 1;
  Writer w{fp};
  w.i32(kMagic);
  w.xdr_string(kVersion);
  w.i32(0);                       // ir_size
  w.i32(0);                       // e_size
  w.i32(box9 ? 9 * 4 : 0);        // box_size
  w.i32(0);                       // vir_size
  w.i32(0);                       // pres_size
  w.i32(0);                       // top_size
  w.i32(0);                       // sym_size
  w.i32(x ? natoms * 3 * 4 : 0);  // x_size
  w.i32(v ? natoms * 3 * 4 : 0);  // v_size
  w.i32(frc ? natoms * 3 * 4 : 0);
  w.i32(natoms);
  w.i32(step);
  w.i32(0);                       // nre
  w.f32(time);
  w.f32(lambda);
  if (box9) w.f32_array_swapped(box9, 9);
  if (x) w.f32_array_swapped(x, static_cast<size_t>(natoms) * 3);
  if (v) w.f32_array_swapped(v, static_cast<size_t>(natoms) * 3);
  if (frc) w.f32_array_swapped(frc, static_cast<size_t>(natoms) * 3);
  int rc = w.ok ? 0 : 2;
  fclose(fp);
  return rc;
}

// Counts frames and returns natoms of the first frame (-1 on error).
int trr_scan(const char* path, int* natoms_out, int* nframes_out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  int frames = 0;
  int natoms = -1;
  while (true) {
    Reader r{fp};
    long start = ftell(fp);
    int32_t magic = r.i32();
    if (!r.ok) break;  // EOF
    if (magic != kMagic) {
      fclose(fp);
      return 2;
    }
    r.skip_string();
    int32_t sizes[10];
    for (int i = 0; i < 10; ++i) sizes[i] = r.i32();
    int32_t na = r.i32();
    r.i32();  // step
    r.i32();  // nre
    r.f32();  // time
    r.f32();  // lambda
    long payload = sizes[2] + sizes[3] + sizes[4] + sizes[7] + sizes[8] +
                   sizes[9];
    if (fseek(fp, payload, SEEK_CUR) != 0 || !r.ok) break;
    if (natoms < 0) natoms = na;
    frames++;
    (void)start;
  }
  fclose(fp);
  *natoms_out = natoms;
  *nframes_out = frames;
  return 0;
}

// Reads frame `index` (0-based).  Buffers hold cap*3 floats (a frame of
// more atoms returns 5); box9 holds 9.  has_* outputs are 0/1.  Returns 0
// on success.
int trr_read_frame(const char* path, int index, int cap, float* box9,
                   float* x,
                   float* v, float* frc, int* step_out, float* time_out,
                   float* lambda_out, int* has_x, int* has_v, int* has_f) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  for (int fr = 0;; ++fr) {
    Reader r{fp};
    int32_t magic = r.i32();
    if (!r.ok) {
      fclose(fp);
      return 3;  // frame not found
    }
    if (magic != kMagic) {
      fclose(fp);
      return 2;
    }
    r.skip_string();
    int32_t sizes[10];
    for (int i = 0; i < 10; ++i) sizes[i] = r.i32();
    int32_t na = r.i32();
    int32_t step = r.i32();
    r.i32();
    float t = r.f32();
    float lam = r.f32();
    if (fr != index) {
      long payload = sizes[2] + sizes[3] + sizes[4] + sizes[7] + sizes[8] +
                     sizes[9];
      if (fseek(fp, payload, SEEK_CUR) != 0) {
        fclose(fp);
        return 3;
      }
      continue;
    }
    if (na < 0 || na > cap) {
      fclose(fp);
      return 5;
    }
    if (sizes[2] == 9 * 4) {
      r.f32_array_swapped(box9, 9);
    }
    if (sizes[3]) fseek(fp, sizes[3], SEEK_CUR);
    if (sizes[4]) fseek(fp, sizes[4], SEEK_CUR);
    *has_x = sizes[7] != 0;
    *has_v = sizes[8] != 0;
    *has_f = sizes[9] != 0;
    size_t n3 = static_cast<size_t>(na) * 3;
    if (*has_x) r.f32_array_swapped(x, n3);
    if (*has_v) r.f32_array_swapped(v, n3);
    if (*has_f) r.f32_array_swapped(frc, n3);
    *step_out = step;
    *time_out = t;
    *lambda_out = lam;
    int rc = r.ok ? 0 : 4;
    fclose(fp);
    return rc;
  }
}

}  // extern "C"
