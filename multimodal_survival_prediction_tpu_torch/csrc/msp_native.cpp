// Native host-side I/O + preprocessing: the PyTorch port's own copy of the
// JAX package's csrc/msp_native.cpp, with the same C ABI.
//
// Replaces the native layer the reference gets from SimpleITK/ITK (C++) and
// scipy.ndimage (C): NIfTI-1 decode (gzip via zlib) and a trilinear
// resample+normalize on the host. Exposed as a plain C ABI for ctypes. All
// entry points are GIL-free from Python's perspective, so a thread pool of
// decoders scales across cores — unlike the pure-Python reader, which
// serializes on the GIL.
//
// Build: data/native.py builds it on first use with the host compiler
// (ops/_build.py:build_host, into build/kernels/). -DMSP_NO_ZLIB leaves out
// the gzip reader alone, for a machine without zlib: the msp_nifti_open*
// entry points then refuse .gz paths, and the resample is unchanged.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>
#ifndef MSP_NO_ZLIB
#include <zlib.h>
#endif

namespace {

constexpr int kHdrSize = 348;

struct NiftiData {
  std::vector<float> voxels;      // (D, H, W) C-order (converting path)
  std::vector<uint8_t> raw;       // payload in on-disk dtype (raw path)
  int32_t dtype_code = 0;         // NIfTI datatype code when raw, else 0
  int64_t dims[3];                // D, H, W
  float spacing[3];               // x, y, z
  float origin[3];
};

// Element size per supported NIfTI datatype code (0 = unsupported).
size_t dtype_esize(int16_t code) {
  switch (code) {
    case 2: case 256: return 1;   // uint8 / int8
    case 4: case 512: return 2;   // int16 / uint16
    case 8: case 16:  return 4;   // int32 / float32
    case 64:          return 8;   // float64
    default:          return 0;
  }
}

// -- gzip / raw file load ---------------------------------------------------

bool read_whole_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(sz));
  size_t got = std::fread(out.data(), 1, out.size(), f);
  std::fclose(f);
  return got == out.size();
}

bool load_file(const char* path, std::vector<uint8_t>& out) {
  size_t n = std::strlen(path);
  bool gz = n > 3 && std::strcmp(path + n - 3, ".gz") == 0;
  if (!gz) return read_whole_file(path, out);
#ifdef MSP_NO_ZLIB
  return false;  // no gzip reader in this build: the caller falls back
#else

  // Whole-buffer raw inflate: the gzFile streaming API is ~5x slower than a
  // single inflate() pass (measured), so read the compressed bytes and
  // decompress in one shot, sizing from the gzip trailer's ISIZE field
  // (decompressed size mod 2^32 — exact for any volume < 4 GB).
  std::vector<uint8_t> comp;
  if (!read_whole_file(path, comp) || comp.size() < 18) return false;
  const uint8_t* tail = comp.data() + comp.size() - 4;
  uint32_t isize = static_cast<uint32_t>(tail[0]) |
                   (static_cast<uint32_t>(tail[1]) << 8) |
                   (static_cast<uint32_t>(tail[2]) << 16) |
                   (static_cast<uint32_t>(tail[3]) << 24);
  out.resize(isize ? isize : (comp.size() * 4));

  z_stream strm{};
  if (inflateInit2(&strm, 16 + MAX_WBITS) != Z_OK) return false;
  strm.next_in = comp.data();
  strm.avail_in = static_cast<uInt>(comp.size());
  size_t total = 0;
  int rc = Z_OK;
  while (rc != Z_STREAM_END) {
    if (total == out.size()) out.resize(out.size() * 2);  // ISIZE wrapped
    strm.next_out = out.data() + total;
    strm.avail_out = static_cast<uInt>(out.size() - total);
    rc = inflate(&strm, Z_NO_FLUSH);
    if (rc != Z_OK && rc != Z_STREAM_END) {
      inflateEnd(&strm);
      return false;
    }
    total = out.size() - strm.avail_out;
  }
  inflateEnd(&strm);
  out.resize(total);
  return true;
#endif
}

template <typename T>
T rd(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}

// Convert on-disk Fortran-order (x fastest) voxels to (D,H,W) float32.
template <typename T>
void transpose_to_dhw(const uint8_t* src, int64_t nx, int64_t ny, int64_t nz,
                      float slope, float inter, std::vector<float>& out) {
  out.resize(static_cast<size_t>(nx) * ny * nz);
  const T* s = reinterpret_cast<const T*>(src);
  for (int64_t z = 0; z < nz; ++z)
    for (int64_t y = 0; y < ny; ++y) {
      const T* row = s + z * nx * ny + y * nx;
      float* dst = out.data() + (z * ny + y) * nx;
      for (int64_t x = 0; x < nx; ++x)
        dst[x] = static_cast<float>(row[x]) * slope + inter;
    }
}

// allow_raw: when scl slope/inter are trivial (slope 0 or 1, inter 0 — the
// common CT case), keep the payload in its on-disk dtype with ZERO
// conversion work: NIfTI stores x-fastest (Fortran (x,y,z)), which is
// byte-identical to C-order (D,H,W)=(z,y,x), so the "transpose" is a single
// memcpy. Matches data/nifti.py's pure-Python semantics (it also keeps the
// native dtype in that case). Non-trivial scaling falls back to the
// converting float32 path.
NiftiData* decode_nifti(const char* path, bool allow_raw = false) {
  std::vector<uint8_t> raw;
  if (!load_file(path, raw) || raw.size() < kHdrSize + 4) return nullptr;
  const uint8_t* h = raw.data();
  if (rd<int32_t>(h) != kHdrSize) return nullptr;  // big-endian unsupported here
  int16_t ndim = rd<int16_t>(h + 40);
  if (ndim < 3) return nullptr;
  int64_t nx = rd<int16_t>(h + 42), ny = rd<int16_t>(h + 44),
          nz = rd<int16_t>(h + 46);
  int16_t datatype = rd<int16_t>(h + 70);
  float pixdim[3] = {rd<float>(h + 80), rd<float>(h + 84), rd<float>(h + 88)};
  float vox_offset = rd<float>(h + 108);
  float slope = rd<float>(h + 112), inter = rd<float>(h + 116);
  if (slope == 0.0f) slope = 1.0f;
  float qoff[3] = {rd<float>(h + 268), rd<float>(h + 272), rd<float>(h + 276)};
  const char* magic = reinterpret_cast<const char*>(h + 344);
  if (std::strncmp(magic, "n+1", 3) != 0 && std::strncmp(magic, "ni1", 3) != 0)
    return nullptr;

  // Corrupt-header guards: nonpositive dims would poison the size math, and
  // a vox_offset outside [header_end, file_size] (incl. NaN/negative, UB on
  // float->size_t cast) would underflow `avail` below and pass the bounds
  // check while reading out of range. Reject -> caller degrades the file to
  // the missing-modality path instead of segfaulting.
  if (nx <= 0 || ny <= 0 || nz <= 0) return nullptr;
  if (!(vox_offset >= static_cast<float>(kHdrSize + 4)) ||
      vox_offset > static_cast<float>(raw.size()))
    return nullptr;
  size_t off = static_cast<size_t>(vox_offset);
  if (off > raw.size()) return nullptr;  // float rounding near the edge
  size_t nvox = static_cast<size_t>(nx) * ny * nz;
  auto* out = new NiftiData();
  out->dims[0] = nz; out->dims[1] = ny; out->dims[2] = nx;
  for (int i = 0; i < 3; ++i) { out->spacing[i] = pixdim[i]; out->origin[i] = qoff[i]; }

  const uint8_t* v = raw.data() + off;
  size_t avail = raw.size() - off;

  size_t esize = dtype_esize(datatype);
  bool trivial_scale = (slope == 1.0f) && (inter == 0.0f);
  if (allow_raw && trivial_scale && esize > 0 && avail >= nvox * esize) {
    out->dtype_code = datatype;
    out->raw.assign(v, v + nvox * esize);
    return out;
  }

  bool ok = true;
  switch (datatype) {
    case 2:   ok = avail >= nvox * 1; if (ok) transpose_to_dhw<uint8_t >(v, nx, ny, nz, slope, inter, out->voxels); break;
    case 4:   ok = avail >= nvox * 2; if (ok) transpose_to_dhw<int16_t >(v, nx, ny, nz, slope, inter, out->voxels); break;
    case 8:   ok = avail >= nvox * 4; if (ok) transpose_to_dhw<int32_t >(v, nx, ny, nz, slope, inter, out->voxels); break;
    case 16:  ok = avail >= nvox * 4; if (ok) transpose_to_dhw<float   >(v, nx, ny, nz, slope, inter, out->voxels); break;
    case 64:  ok = avail >= nvox * 8; if (ok) transpose_to_dhw<double  >(v, nx, ny, nz, slope, inter, out->voxels); break;
    case 256: ok = avail >= nvox * 1; if (ok) transpose_to_dhw<int8_t  >(v, nx, ny, nz, slope, inter, out->voxels); break;
    case 512: ok = avail >= nvox * 2; if (ok) transpose_to_dhw<uint16_t>(v, nx, ny, nz, slope, inter, out->voxels); break;
    default:  ok = false;
  }
  if (!ok) { delete out; return nullptr; }
  return out;
}

// scipy.ndimage.zoom(order=1, grid_mode=False) coordinate convention:
// in_coord = out_coord * (in-1)/(out-1)  (align-corners; matches
// ops/resample.py linear_interp_matrix)
inline void interp_axis(int64_t in, int64_t out, std::vector<int>& lo,
                        std::vector<float>& frac) {
  lo.resize(out); frac.resize(out);
  for (int64_t o = 0; o < out; ++o) {
    if (in == 1 || out == 1) { lo[o] = 0; frac[o] = 0.f; continue; }
    double c = static_cast<double>(o) * (in - 1) / (out - 1);
    int64_t l = static_cast<int64_t>(std::floor(c));
    if (l > in - 2) l = in - 2;
    lo[o] = static_cast<int>(l);
    frac[o] = static_cast<float>(c - l);
  }
}

}  // namespace

extern "C" {

// Open + decode; returns handle (or null). dims/spacing/origin filled.
void* msp_nifti_open(const char* path, int64_t dims[3], float spacing[3],
                     float origin[3]) {
  NiftiData* d = decode_nifti(path);
  if (!d) return nullptr;
  for (int i = 0; i < 3; ++i) {
    dims[i] = d->dims[i];
    spacing[i] = d->spacing[i];
    origin[i] = d->origin[i];
  }
  return d;
}

// Open + decode, keeping the on-disk dtype when scaling is trivial.
// dtype_code receives the NIfTI datatype code for the raw payload, or 0 if
// the volume needed float32 conversion (then read it with msp_nifti_copy).
void* msp_nifti_open_any(const char* path, int64_t dims[3], float spacing[3],
                         float origin[3], int32_t* dtype_code) {
  NiftiData* d = decode_nifti(path, /*allow_raw=*/true);
  if (!d) return nullptr;
  for (int i = 0; i < 3; ++i) {
    dims[i] = d->dims[i];
    spacing[i] = d->spacing[i];
    origin[i] = d->origin[i];
  }
  *dtype_code = d->dtype_code;
  return d;
}

// Copy the raw-dtype payload into caller buffer (nbytes must match).
int msp_nifti_copy_raw(void* handle, uint8_t* out, int64_t nbytes) {
  auto* d = static_cast<NiftiData*>(handle);
  if (!d || d->dtype_code == 0) return -1;
  if (static_cast<size_t>(nbytes) != d->raw.size()) return -2;
  std::memcpy(out, d->raw.data(), d->raw.size());
  return 0;
}

// Copy decoded (D,H,W) float32 voxels into caller buffer.
int msp_nifti_copy(void* handle, float* out) {
  auto* d = static_cast<NiftiData*>(handle);
  if (!d) return -1;
  std::memcpy(out, d->voxels.data(), d->voxels.size() * sizeof(float));
  return 0;
}

void msp_nifti_close(void* handle) {
  delete static_cast<NiftiData*>(handle);
}

}  // extern "C" (templates below can't carry C linkage)

// Fused minmax-normalize + trilinear resample (host twin of the device
// resample, ops/resample.py). Reads the volume in its NATIVE dtype (int16 CTs
// never materialize a float32 copy), optional CT Hounsfield window clamp
// fused into the same pass — matches resample_normalize's
// clip -> min/max -> interpolate -> affine order.
namespace {

template <typename T>
int resample_normalize_impl(const T* in, int64_t d, int64_t h, int64_t w,
                            float* out, int64_t od, int64_t oh, int64_t ow,
                            bool use_hu, float hu_lo, float hu_hi) {
  if (d < 1 || h < 1 || w < 1 || od < 1 || oh < 1 || ow < 1) return -1;
  auto val = [&](const T* p, int64_t i) -> float {
    float v = static_cast<float>(p[i]);
    if (use_hu) v = v < hu_lo ? hu_lo : (v > hu_hi ? hu_hi : v);
    return v;
  };
  // pass 1: min/max (over the clamped values when windowing). This pass
  // touches every voxel (the interpolation below touches ~8 per OUTPUT
  // voxel, ~300x fewer), so it must run at memory speed: the no-window
  // case reduces in the NATIVE dtype with branch-free ternaries (the
  // float-converting if-chain defeats g++ auto-vectorization — measured
  // ~3x slower on int16 CTs); conversion to float is monotone, so the
  // native-dtype extrema ARE the float extrema.
  const int64_t n = d * h * w;
  T tmn = in[0], tmx = in[0];
  for (int64_t i = 1; i < n; ++i) {
    const T v = in[i];
    tmn = v < tmn ? v : tmn;
    tmx = v > tmx ? v : tmx;
  }
  float mn = static_cast<float>(tmn);
  float mx = static_cast<float>(tmx);
  if (use_hu) {
    // clamp is monotone, so clamp(min) == min(clamped) — the windowed
    // extrema come from the native-dtype pass for free (a separate
    // float-converting clamped reduction measured ~30x slower)
    mn = mn < hu_lo ? hu_lo : (mn > hu_hi ? hu_hi : mn);
    mx = mx < hu_lo ? hu_lo : (mx > hu_hi ? hu_hi : mx);
  }
  const float scale = 1.0f / (mx - mn + 1e-8f);

  std::vector<int> zlo, ylo, xlo;
  std::vector<float> zf, yf, xf;
  interp_axis(d, od, zlo, zf);
  interp_axis(h, oh, ylo, yf);
  interp_axis(w, ow, xlo, xf);

  const int64_t hw = h * w;
  for (int64_t oz = 0; oz < od; ++oz) {
    const int z0 = zlo[oz];
    const float fz = zf[oz];
    const int64_t z1 = (d > 1) ? z0 + 1 : z0;
    for (int64_t oy = 0; oy < oh; ++oy) {
      const int y0 = ylo[oy];
      const float fy = yf[oy];
      const int64_t y1 = (h > 1) ? y0 + 1 : y0;
      float* dst = out + (oz * oh + oy) * ow;
      const T* p00 = in + z0 * hw + y0 * w;
      const T* p01 = in + z0 * hw + y1 * w;
      const T* p10 = in + z1 * hw + y0 * w;
      const T* p11 = in + z1 * hw + y1 * w;
      for (int64_t ox = 0; ox < ow; ++ox) {
        const int x0 = xlo[ox];
        const float fx = xf[ox];
        const int64_t x1 = (w > 1) ? x0 + 1 : x0;
        const float c00 = val(p00, x0) * (1 - fx) + val(p00, x1) * fx;
        const float c01 = val(p01, x0) * (1 - fx) + val(p01, x1) * fx;
        const float c10 = val(p10, x0) * (1 - fx) + val(p10, x1) * fx;
        const float c11 = val(p11, x0) * (1 - fx) + val(p11, x1) * fx;
        const float c0 = c00 * (1 - fy) + c01 * fy;
        const float c1 = c10 * (1 - fy) + c11 * fy;
        dst[ox] = ((c0 * (1 - fz) + c1 * fz) - mn) * scale;
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Original float32 entry point (kept for ABI stability).
int msp_resample_normalize(const float* in, int64_t d, int64_t h, int64_t w,
                           float* out, int64_t od, int64_t oh, int64_t ow) {
  return resample_normalize_impl<float>(in, d, h, w, out, od, oh, ow,
                                        false, 0.f, 0.f);
}

// Native-dtype entry point: dtype_code uses the NIfTI datatype codes
// (4=int16 CT — the hot case: no float32 materialization of the 80 MB
// volume; 16=float32; others as supported). use_hu!=0 clamps values into
// [hu_lo, hu_hi] before the min/max + interpolation, matching the device
// path's hu_window.
int msp_resample_normalize_any(const void* in, int32_t dtype_code,
                               int64_t d, int64_t h, int64_t w,
                               float* out, int64_t od, int64_t oh, int64_t ow,
                               int32_t use_hu, float hu_lo, float hu_hi) {
  const bool hu = use_hu != 0;
  switch (dtype_code) {
    case 2:   return resample_normalize_impl<uint8_t >(static_cast<const uint8_t* >(in), d, h, w, out, od, oh, ow, hu, hu_lo, hu_hi);
    case 4:   return resample_normalize_impl<int16_t >(static_cast<const int16_t* >(in), d, h, w, out, od, oh, ow, hu, hu_lo, hu_hi);
    case 8:   return resample_normalize_impl<int32_t >(static_cast<const int32_t* >(in), d, h, w, out, od, oh, ow, hu, hu_lo, hu_hi);
    case 16:  return resample_normalize_impl<float   >(static_cast<const float*   >(in), d, h, w, out, od, oh, ow, hu, hu_lo, hu_hi);
    case 64:  return resample_normalize_impl<double  >(static_cast<const double*  >(in), d, h, w, out, od, oh, ow, hu, hu_lo, hu_hi);
    case 256: return resample_normalize_impl<int8_t  >(static_cast<const int8_t*  >(in), d, h, w, out, od, oh, ow, hu, hu_lo, hu_hi);
    case 512: return resample_normalize_impl<uint16_t>(static_cast<const uint16_t*>(in), d, h, w, out, od, oh, ow, hu, hu_lo, hu_hi);
    default:  return -2;
  }
}

}  // extern "C"
