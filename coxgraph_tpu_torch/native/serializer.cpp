// Compact wire serialization of block-sparse TSDF layers.
//
// Replaces the reference's voxblox serializeLayerAsMsg/deserializeMsgToLayer
// (used at msg_converter.h:48-50,107-112) plus the bandwidth-saving intent
// of its mesh_with_history transport (SURVEY.md §2.4): submaps are shipped
// once (coxgraph_client.cpp:60-66), so the wire format is the bandwidth
// bottleneck of the whole system.
//
// Format (little-endian):
//   header: magic u32 | version u32 | n_blocks u32 | vps u32 |
//           truncation f32 | voxel_size f32
//   per block:
//     coords 3×i32
//     occupancy bitmap (vps³/8 bytes)  — voxel has weight > w_eps
//     for each observed voxel (bitmap order):
//       sdf  i16  (sdf / truncation × 32000, clamped)
//       wgt  u16  (log1p(w)/log1p(MAX_W) × 65535)
//       rgb  3×u8
//
// Exposed as a plain C API for ctypes; no dependencies beyond libc/libm.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t kMagic = 0x434f5854;  // "COXT"
constexpr uint32_t kVersion = 1;
constexpr float kMaxWeight = 1.0e4f;
constexpr float kWeightEps = 1.0e-6f;

inline int16_t quantize_sdf(float sdf, float trunc) {
  float q = sdf / trunc * 32000.0f;
  if (q > 32000.0f) q = 32000.0f;
  if (q < -32000.0f) q = -32000.0f;
  return static_cast<int16_t>(q);
}

inline float dequantize_sdf(int16_t q, float trunc) {
  return static_cast<float>(q) / 32000.0f * trunc;
}

inline uint16_t quantize_w(float w) {
  if (w < 0.0f) w = 0.0f;
  if (w > kMaxWeight) w = kMaxWeight;
  float q = std::log1p(w) / std::log1p(kMaxWeight) * 65535.0f;
  return static_cast<uint16_t>(q);
}

inline float dequantize_w(uint16_t q) {
  return std::expm1(static_cast<float>(q) / 65535.0f *
                    std::log1p(kMaxWeight));
}

inline uint8_t quantize_c(float c) {
  float q = c * 255.0f;
  if (q < 0.0f) q = 0.0f;
  if (q > 255.0f) q = 255.0f;
  return static_cast<uint8_t>(q);
}

struct Writer {
  uint8_t* p;
  size_t cap;
  size_t off = 0;
  bool ok = true;
  void bytes(const void* src, size_t n) {
    if (off + n > cap) { ok = false; return; }
    std::memcpy(p + off, src, n);
    off += n;
  }
  template <typename T> void put(T v) { bytes(&v, sizeof(T)); }
};

struct Reader {
  const uint8_t* p;
  size_t cap;
  size_t off = 0;
  bool ok = true;
  void bytes(void* dst, size_t n) {
    if (off + n > cap) { ok = false; return; }
    std::memcpy(dst, p + off, n);
    off += n;
  }
  template <typename T> T get() { T v{}; bytes(&v, sizeof(T)); return v; }
};

}  // namespace

extern "C" {

// Upper bound on the encoded size for buffer allocation.
size_t cox_serialized_bound(uint32_t n_blocks, uint32_t vps) {
  const size_t vox = static_cast<size_t>(vps) * vps * vps;
  return 24 + static_cast<size_t>(n_blocks) * (12 + vox / 8 + vox * 7);
}

// Serialize. Returns bytes written, or 0 on failure.
// sdf/weight: [n_blocks][vps^3] f32; color: [n_blocks][3][vps^3] f32
// (PLANAR channel layout, matching the device pool); coords:
// [n_blocks][3] i32. The wire format is unchanged (interleaved rgb per
// occupied voxel).
size_t cox_serialize(const int32_t* coords, const float* sdf,
                     const float* weight, const float* color,
                     uint32_t n_blocks, uint32_t vps, float truncation,
                     float voxel_size, uint8_t* out, size_t out_cap) {
  Writer w{out, out_cap};
  w.put(kMagic);
  w.put(kVersion);
  w.put(n_blocks);
  w.put(vps);
  w.put(truncation);
  w.put(voxel_size);
  const size_t vox = static_cast<size_t>(vps) * vps * vps;
  const size_t bm_bytes = vox / 8;

  for (uint32_t b = 0; b < n_blocks && w.ok; ++b) {
    w.bytes(coords + 3 * b, 12);
    const float* bs = sdf + b * vox;
    const float* bw = weight + b * vox;
    const float* bc = color + b * vox * 3;
    // occupancy bitmap
    if (w.off + bm_bytes > w.cap) return 0;
    uint8_t* bm = w.p + w.off;
    std::memset(bm, 0, bm_bytes);
    for (size_t i = 0; i < vox; ++i) {
      if (bw[i] > kWeightEps) bm[i >> 3] |= static_cast<uint8_t>(1u << (i & 7));
    }
    w.off += bm_bytes;
    for (size_t i = 0; i < vox && w.ok; ++i) {
      if (bw[i] <= kWeightEps) continue;
      w.put(quantize_sdf(bs[i], truncation));
      w.put(quantize_w(bw[i]));
      uint8_t rgb[3] = {quantize_c(bc[i]), quantize_c(bc[vox + i]),
                        quantize_c(bc[2 * vox + i])};
      w.bytes(rgb, 3);
    }
  }
  return w.ok ? w.off : 0;
}

// Peek the header. Returns 0 on success.
int cox_peek(const uint8_t* buf, size_t len, uint32_t* n_blocks,
             uint32_t* vps, float* truncation, float* voxel_size) {
  Reader r{buf, len};
  if (r.get<uint32_t>() != kMagic) return 1;
  if (r.get<uint32_t>() != kVersion) return 2;
  *n_blocks = r.get<uint32_t>();
  *vps = r.get<uint32_t>();
  *truncation = r.get<float>();
  *voxel_size = r.get<float>();
  return r.ok ? 0 : 3;
}

// Deserialize into caller-allocated arrays (sized from cox_peek).
// Unobserved voxels get sdf=truncation, weight=0, color=0.
int cox_deserialize(const uint8_t* buf, size_t len, int32_t* coords,
                    float* sdf, float* weight, float* color) {
  Reader r{buf, len};
  if (r.get<uint32_t>() != kMagic) return 1;
  if (r.get<uint32_t>() != kVersion) return 2;
  const uint32_t n_blocks = r.get<uint32_t>();
  const uint32_t vps = r.get<uint32_t>();
  const float truncation = r.get<float>();
  (void)r.get<float>();  // voxel_size
  const size_t vox = static_cast<size_t>(vps) * vps * vps;
  const size_t bm_bytes = vox / 8;

  for (uint32_t b = 0; b < n_blocks && r.ok; ++b) {
    r.bytes(coords + 3 * b, 12);
    if (r.off + bm_bytes > r.cap) return 3;
    const uint8_t* bm = r.p + r.off;
    r.off += bm_bytes;
    float* bs = sdf + b * vox;
    float* bw = weight + b * vox;
    float* bc = color + b * vox * 3;
    for (size_t i = 0; i < vox && r.ok; ++i) {
      if (bm[i >> 3] & (1u << (i & 7))) {
        bs[i] = dequantize_sdf(r.get<int16_t>(), truncation);
        bw[i] = dequantize_w(r.get<uint16_t>());
        uint8_t rgb[3];
        r.bytes(rgb, 3);
        bc[i] = rgb[0] / 255.0f;
        bc[vox + i] = rgb[1] / 255.0f;
        bc[2 * vox + i] = rgb[2] / 255.0f;
      } else {
        bs[i] = truncation;
        bw[i] = 0.0f;
        bc[i] = bc[vox + i] = bc[2 * vox + i] = 0.0f;
      }
    }
  }
  return r.ok ? 0 : 4;
}

}  // extern "C"
