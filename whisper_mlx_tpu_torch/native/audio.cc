// Host-side audio and alignment helpers of the PyTorch port, in C++.
// A copy of whisper_mlx_tpu/native/audio.cc less its resampler (resampling
// is scipy's, audio/decode.py:resample): the device path is PyTorch on
// CUDA; this library is host code around it (WAV decode, the DTW of
// word-timestamp alignment). Nothing here runs on the GPU.
//
// Exposed C ABI (loaded via ctypes: whisper_mlx_tpu_torch/native/__init__.py):
//   int  wtpu_read_wav(path, float** out, long long* n, int* sample_rate)
//   long long wtpu_dtw(const float* cost, long long n, long long m,
//                      int* out_text, int* out_time)
//   void wtpu_free(float* p)
//
// Behavior matches audio/decode.py's NumPy reader exactly: RIFF parse of
// PCM 8/16/24/32-bit int and 32/64-bit float, channel mean-downmix.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

void wtpu_free(float* p) { std::free(p); }

static uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

// returns 0 on success; negative error codes otherwise
int wtpu_read_wav(const char* path, float** out, long long* out_n,
                  int* out_rate) {
  *out = nullptr;
  *out_n = 0;
  *out_rate = 0;
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 12) {
    std::fclose(f);
    return -2;
  }
  std::vector<uint8_t> buf((size_t)size);
  if (std::fread(buf.data(), 1, (size_t)size, f) != (size_t)size) {
    std::fclose(f);
    return -3;
  }
  std::fclose(f);

  if (std::memcmp(buf.data(), "RIFF", 4) != 0 ||
      std::memcmp(buf.data() + 8, "WAVE", 4) != 0)
    return -4;

  uint16_t fmt_code = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* data = nullptr;
  size_t data_len = 0;
  size_t pos = 12;
  while (pos + 8 <= (size_t)size) {
    const uint8_t* chunk = buf.data() + pos;
    uint32_t chunk_len = rd_u32(chunk + 4);
    const uint8_t* body = chunk + 8;
    if (pos + 8 + chunk_len > (size_t)size) break;
    if (std::memcmp(chunk, "fmt ", 4) == 0 && chunk_len >= 16) {
      fmt_code = rd_u16(body);
      channels = rd_u16(body + 2);
      rate = rd_u32(body + 4);
      bits = rd_u16(body + 14);
    } else if (std::memcmp(chunk, "data", 4) == 0) {
      data = body;
      data_len = chunk_len;
    }
    pos += 8 + chunk_len + (chunk_len & 1);  // word alignment
  }
  if (!data || !rate || !channels || !bits) return -5;

  size_t bytes_per = bits / 8;
  size_t n_samples = data_len / bytes_per;
  std::vector<float> mono;
  std::vector<float> interleaved(n_samples);

  if (fmt_code == 1) {  // PCM int
    switch (bits) {
      case 8:
        for (size_t i = 0; i < n_samples; i++)
          interleaved[i] = ((float)data[i] - 128.0f) / 128.0f;
        break;
      case 16:
        for (size_t i = 0; i < n_samples; i++) {
          int16_t v = (int16_t)rd_u16(data + 2 * i);
          interleaved[i] = (float)v / 32768.0f;
        }
        break;
      case 24:
        for (size_t i = 0; i < n_samples; i++) {
          const uint8_t* p = data + 3 * i;
          int32_t v = (int32_t)p[0] | ((int32_t)p[1] << 8) | ((int32_t)p[2] << 16);
          if (v & 0x800000) v -= 0x1000000;
          interleaved[i] = (float)v / 8388608.0f;
        }
        break;
      case 32:
        for (size_t i = 0; i < n_samples; i++) {
          int32_t v = (int32_t)rd_u32(data + 4 * i);
          interleaved[i] = (float)v / 2147483648.0f;
        }
        break;
      default:
        return -6;
    }
  } else if (fmt_code == 3) {  // IEEE float
    if (bits == 32) {
      for (size_t i = 0; i < n_samples; i++) {
        uint32_t raw = rd_u32(data + 4 * i);
        float v;
        std::memcpy(&v, &raw, 4);
        interleaved[i] = v;
      }
    } else if (bits == 64) {
      for (size_t i = 0; i < n_samples; i++) {
        uint64_t raw = (uint64_t)rd_u32(data + 8 * i) |
                       ((uint64_t)rd_u32(data + 8 * i + 4) << 32);
        double v;
        std::memcpy(&v, &raw, 8);
        interleaved[i] = (float)v;
      }
    } else {
      return -6;
    }
  } else {
    return -7;
  }

  size_t frames = n_samples / channels;
  mono.resize(frames);
  if (channels == 1) {
    mono = std::move(interleaved);
    mono.resize(frames);
  } else {
    for (size_t i = 0; i < frames; i++) {
      float acc = 0.0f;
      for (size_t c = 0; c < channels; c++) acc += interleaved[i * channels + c];
      mono[i] = acc / (float)channels;
    }
  }

  float* result = (float*)std::malloc(mono.size() * sizeof(float));
  if (!result) return -8;
  std::memcpy(result, mono.data(), mono.size() * sizeof(float));
  *out = result;
  *out_n = (long long)mono.size();
  *out_rate = (int)rate;
  return 0;
}

}  // extern "C"

extern "C" {

// DTW with 3-move traceback (native counterpart of
// inference/word_timestamps.py::dtw).
// cost: row-major (n, m). Writes the monotone alignment path into
// out_text/out_time (caller-allocated, capacity n+m); returns path length.
long long wtpu_dtw(const float* cost, long long n, long long m,
                   int* out_text, int* out_time) {
  if (n <= 0 || m <= 0) return -1;
  const double INF = 1e300;
  std::vector<double> prev((size_t)m + 1, INF), cur((size_t)m + 1, INF);
  std::vector<int8_t> trace((size_t)(n + 1) * (m + 1), 0);
  prev[0] = 0.0;
  for (long long i = 1; i <= n; i++) {
    cur[0] = INF;
    const float* row = cost + (i - 1) * m;
    for (long long j = 1; j <= m; j++) {
      // openai/transformers tie-break verbatim (generation_whisper.py
      // _dynamic_time_warping): diag/down only when STRICTLY smaller than
      // both alternatives, else right — paths bit-identical on ties
      const double c0 = prev[j - 1];   // diagonal
      const double c1 = prev[j];       // down
      const double c2 = cur[j - 1];    // right
      double best;
      int8_t move;
      if (c0 < c1 && c0 < c2)      { best = c0; move = 0; }
      else if (c1 < c0 && c1 < c2) { best = c1; move = 1; }
      else                         { best = c2; move = 2; }
      cur[j] = row[j - 1] + best;
      trace[(size_t)i * (m + 1) + j] = move;
    }
    std::swap(prev, cur);
  }
  // traceback
  long long i = n, j = m, len = 0;
  std::vector<int> ti, tj;
  while (i > 0 && j > 0) {
    ti.push_back((int)(i - 1));
    tj.push_back((int)(j - 1));
    int8_t move = trace[(size_t)i * (m + 1) + j];
    if (move == 0) { i--; j--; }
    else if (move == 1) { i--; }
    else { j--; }
  }
  len = (long long)ti.size();
  for (long long p = 0; p < len; p++) {
    out_text[p] = ti[(size_t)(len - 1 - p)];
    out_time[p] = tj[(size_t)(len - 1 - p)];
  }
  return len;
}

}  // extern "C"
