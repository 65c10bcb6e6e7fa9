// Copy of cpp/wavio.cc for the PyTorch port; only the path of its ctypes shim changed.
// Minimal RIFF/WAVE decoder: PCM 8/16/24/32-bit and IEEE float32/64 -> float32.
// Native replacement for the torchaudio C++ decode the reference leans on
// (reference: dataset.py:31,104). Exposed to Python via ctypes (see
// whisper_char_alignment_tpu_torch/audio/_wavio_native.py).
//
// Interleaved output: out[frame * channels + ch], caller frees with wavio_free.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) { return (uint16_t)p[0] | ((uint16_t)p[1] << 8); }

}  // namespace

namespace {

// Returns 0 on success. Error codes: 1 io, 2 not-wav, 3 missing chunk,
// 4 unsupported format.
int wavio_load_impl(const char* path, float** out, int64_t* out_samples,
                    int32_t* out_channels, int32_t* out_rate) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  if (size < 0) {  // pipes / char devices: ftell fails with -1
    std::fclose(f);
    return 1;
  }
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data((size_t)size);
  if (std::fread(data.data(), 1, (size_t)size, f) != (size_t)size) {
    std::fclose(f);
    return 1;
  }
  std::fclose(f);

  if (size < 12 || std::memcmp(data.data(), "RIFF", 4) != 0 ||
      std::memcmp(data.data() + 8, "WAVE", 4) != 0)
    return 2;

  uint16_t fmt_tag = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* payload = nullptr;
  size_t payload_len = 0;
  bool have_fmt = false;

  size_t pos = 12;
  while (pos + 8 <= (size_t)size) {
    const uint8_t* id = data.data() + pos;
    uint32_t csize = rd_u32(data.data() + pos + 4);
    const uint8_t* body = data.data() + pos + 8;
    if (pos + 8 + csize > (size_t)size) csize = (uint32_t)((size_t)size - pos - 8);
    if (std::memcmp(id, "fmt ", 4) == 0 && csize >= 16) {
      fmt_tag = rd_u16(body);
      channels = rd_u16(body + 2);
      rate = rd_u32(body + 4);
      bits = rd_u16(body + 14);
      if (fmt_tag == 0xFFFE) {
        // WAVE_FORMAT_EXTENSIBLE: the real format code is the first 2 bytes
        // of the SubFormat GUID at fmt-body offset 24 (1 = PCM, 3 = float);
        // assuming PCM mis-decoded extensible float WAVs (round-4 review)
        fmt_tag = (csize >= 26) ? rd_u16(body + 24) : 1;
      }
      have_fmt = true;
    } else if (std::memcmp(id, "data", 4) == 0) {
      payload = body;
      payload_len = csize;
    }
    pos += 8 + csize + (csize & 1);
  }
  if (!have_fmt || !payload || channels == 0) return 3;

  size_t bytes_per = bits / 8;
  if (bytes_per == 0) return 4;
  size_t total = payload_len / bytes_per;
  size_t frames = total / channels;
  total = frames * channels;

  float* buf = (float*)std::malloc(total * sizeof(float));
  if (!buf) return 1;

  if (fmt_tag == 1 && bits == 16) {
    for (size_t i = 0; i < total; i++) {
      int16_t v = (int16_t)rd_u16(payload + 2 * i);
      buf[i] = (float)v / 32768.0f;
    }
  } else if (fmt_tag == 1 && bits == 8) {
    for (size_t i = 0; i < total; i++)
      buf[i] = ((float)payload[i] - 128.0f) / 128.0f;
  } else if (fmt_tag == 1 && bits == 24) {
    for (size_t i = 0; i < total; i++) {
      const uint8_t* s = payload + 3 * i;
      int32_t v = (int32_t)s[0] | ((int32_t)s[1] << 8) | ((int32_t)s[2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      buf[i] = (float)v / (float)(1 << 23);
    }
  } else if (fmt_tag == 1 && bits == 32) {
    for (size_t i = 0; i < total; i++) {
      int32_t v = (int32_t)rd_u32(payload + 4 * i);
      buf[i] = (float)((double)v / 2147483648.0);
    }
  } else if (fmt_tag == 3 && bits == 32) {
    for (size_t i = 0; i < total; i++) {
      uint32_t u = rd_u32(payload + 4 * i);
      float v;
      std::memcpy(&v, &u, 4);
      buf[i] = v;
    }
  } else if (fmt_tag == 3 && bits == 64) {
    for (size_t i = 0; i < total; i++) {
      uint64_t u = (uint64_t)rd_u32(payload + 8 * i) |
                   ((uint64_t)rd_u32(payload + 8 * i + 4) << 32);
      double v;
      std::memcpy(&v, &u, 8);
      buf[i] = (float)v;
    }
  } else {
    std::free(buf);
    return 4;
  }

  *out = buf;
  *out_samples = (int64_t)frames;
  *out_channels = (int32_t)channels;
  *out_rate = (int32_t)rate;
  return 0;
}

}  // namespace

extern "C" {

int wavio_load(const char* path, float** out, int64_t* out_samples,
               int32_t* out_channels, int32_t* out_rate) {
  // exception barrier: a std::bad_alloc/length_error escaping into the
  // ctypes frames would std::terminate() the whole Python process instead
  // of triggering the documented non-fatal NumPy fallback (wav.py)
  try {
    return wavio_load_impl(path, out, out_samples, out_channels, out_rate);
  } catch (...) {
    return 1;
  }
}

void wavio_free(float* p) { std::free(p); }

}  // extern "C"
