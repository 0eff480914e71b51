// Native parsers for the host-side asset pipeline of reze_tpu_torch.
//
// The PMX vertex block (variable-length records: the one part of the
// format that numpy cannot parse in one vectorized read) and the VMD
// bone-frame records, behind a plain C interface loaded with ctypes by
// ``reze_tpu_torch/formats/native.py``, which builds this file with g++ at
// first use. A record the parser refuses returns -1, and the caller then
// runs the pure-Python parse, which raises on it.
//
// Build: g++ -O3 -shared -fPIC -o libreze_native.so reze_native.cpp

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  template <typename T>
  T read() {
    if (p + sizeof(T) > end) {
      ok = false;
      return T{};
    }
    T v;
    std::memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    return v;
  }

  int32_t read_index(int size) {
    switch (size) {
      case 1:
        return static_cast<int8_t>(read<uint8_t>());
      case 2:
        return read<int16_t>();
      default:
        return read<int32_t>();
    }
  }

  void skip(size_t n) {
    if (p + n > end) {
      ok = false;
      return;
    }
    p += n;
  }
};

}  // namespace

extern "C" {

// Parses the PMX vertex block starting at `offset`. Returns the end offset on
// success, or -1 on malformed input. All output arrays must be preallocated
// by the caller: positions/normals (3*n), uvs (2*n), add_uvs (4*add_uv*n),
// deform_types (n), joints (4*n), weights (4*n), sdef arrays (3*n each,
// nullable), edge_scale (n).
long long reze_parse_pmx_vertices(
    const uint8_t* buf, long long len, long long offset, int vertex_count,
    int add_uv_count, int bone_index_size, float* positions, float* normals,
    float* uvs, float* add_uvs, uint8_t* deform_types, int32_t* joints,
    float* weights, float* sdef_c, float* sdef_r0, float* sdef_r1,
    float* edge_scale, int* has_sdef_out) {
  Cursor c{buf + offset, buf + len};
  int has_sdef = 0;
  for (int i = 0; i < vertex_count; ++i) {
    for (int k = 0; k < 3; ++k) positions[i * 3 + k] = c.read<float>();
    for (int k = 0; k < 3; ++k) normals[i * 3 + k] = c.read<float>();
    for (int k = 0; k < 2; ++k) uvs[i * 2 + k] = c.read<float>();
    for (int k = 0; k < add_uv_count * 4; ++k)
      add_uvs[i * add_uv_count * 4 + k] = c.read<float>();

    uint8_t type = c.read<uint8_t>();
    deform_types[i] = type;
    int32_t* j = joints + i * 4;
    float* w = weights + i * 4;
    j[0] = j[1] = j[2] = j[3] = 0;
    w[0] = w[1] = w[2] = w[3] = 0.f;
    switch (type) {
      case 0:  // BDEF1
        j[0] = c.read_index(bone_index_size);
        w[0] = 1.f;
        break;
      case 1:  // BDEF2
      case 3:  // SDEF
        j[0] = c.read_index(bone_index_size);
        j[1] = c.read_index(bone_index_size);
        w[0] = c.read<float>();
        w[1] = 1.f - w[0];
        if (type == 3) {
          has_sdef = 1;
          for (int k = 0; k < 3; ++k) sdef_c[i * 3 + k] = c.read<float>();
          for (int k = 0; k < 3; ++k) sdef_r0[i * 3 + k] = c.read<float>();
          for (int k = 0; k < 3; ++k) sdef_r1[i * 3 + k] = c.read<float>();
        }
        break;
      case 2:  // BDEF4
      case 4:  // QDEF
        for (int k = 0; k < 4; ++k) j[k] = c.read_index(bone_index_size);
        for (int k = 0; k < 4; ++k) w[k] = c.read<float>();
        break;
      default:
        return -1;
    }
    edge_scale[i] = c.read<float>();
    if (!c.ok) return -1;
  }
  *has_sdef_out = has_sdef;
  return static_cast<long long>(c.p - buf);
}

// Parses `n` VMD bone frames (111 bytes each) starting at `offset` into
// columnar arrays: names (15*n raw bytes), frames (n), positions (3*n),
// rotations (4*n), interp (16*n raw bytes = the canonical first row of the
// 64-byte Bezier block). Returns end offset or -1.
long long reze_parse_vmd_bone_frames(const uint8_t* buf, long long len,
                                     long long offset, int n, uint8_t* names,
                                     uint32_t* frames, float* positions,
                                     float* rotations, uint8_t* interp) {
  if (offset + static_cast<long long>(n) * 111 > len) return -1;
  const uint8_t* p = buf + offset;
  for (int i = 0; i < n; ++i) {
    std::memcpy(names + i * 15, p, 15);
    std::memcpy(frames + i, p + 15, 4);
    std::memcpy(positions + i * 3, p + 19, 12);
    std::memcpy(rotations + i * 4, p + 31, 16);
    std::memcpy(interp + i * 16, p + 47, 16);
    p += 111;
  }
  return offset + static_cast<long long>(n) * 111;
}

}  // extern "C"
