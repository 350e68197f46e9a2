// Native batch wav reader for the drnmf_tpu data pipeline.
//
// Replaces the per-file Python read loop of the reference featurizer
// (util.py:310-352 loops scipy.io.wavfile reads over thousands of CHiME2
// files) with a multithreaded RIFF/PCM16 decoder: the corpus featurization
// is host-IO bound, and overlapping decode across a thread pool keeps the
// device featurization batches fed.
//
// C ABI (ctypes-friendly):
//   wav_info(path, *nsampl, *nch, *fs)      -> 0 on success
//   wav_read(path, out, nch, nsampl)        -> samples scaled by 1/32768,
//                                              channel-major (nch, nsampl)
//   wav_read_batch(paths, n, out, stride, nch_want, lengths, n_threads)
//       out: (n, stride) float32, channel 0 only, zero-padded
//   wav_write(path, data, nsampl, fs)       -> PCM16 with peak normalize
//
// Build: native/build.sh -> libdrnmfio.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <atomic>
#include <thread>
#include <vector>

namespace {

struct WavMeta {
  uint16_t format = 0;
  uint16_t nch = 0;
  uint32_t fs = 0;
  uint16_t bits = 0;
  long data_offset = -1;
  uint32_t data_bytes = 0;
};

bool parse_header(FILE* f, WavMeta* meta) {
  char tag[4];
  uint32_t sz;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "RIFF", 4) != 0) return false;
  if (fread(&sz, 4, 1, f) != 1) return false;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "WAVE", 4) != 0) return false;
  while (fread(tag, 1, 4, f) == 4 && fread(&sz, 4, 1, f) == 1) {
    if (memcmp(tag, "fmt ", 4) == 0) {
      uint8_t buf[16];
      if (sz < 16 || fread(buf, 1, 16, f) != 16) return false;
      memcpy(&meta->format, buf + 0, 2);
      memcpy(&meta->nch, buf + 2, 2);
      memcpy(&meta->fs, buf + 4, 4);
      memcpy(&meta->bits, buf + 14, 2);
      if (sz > 16) fseek(f, sz - 16, SEEK_CUR);
    } else if (memcmp(tag, "data", 4) == 0) {
      meta->data_offset = ftell(f);
      meta->data_bytes = sz;
      return meta->format == 1 && meta->bits == 16 && meta->nch > 0;
    } else {
      fseek(f, sz + (sz & 1), SEEK_CUR);
    }
  }
  return false;
}

// Raw int16 channel-0 read (no float conversion): the scoring engine
// transfers PCM16 bytes host->device and dequantizes on device -- half the
// transfer of float32.
int read_one_i16(const char* path, int16_t* out, int64_t nsampl_max,
                 int64_t* nsampl_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavMeta meta;
  if (!parse_header(f, &meta)) {
    fclose(f);
    return -2;
  }
  const int64_t nsampl =
      static_cast<int64_t>(meta.data_bytes) / (2 * meta.nch);
  const int64_t n = nsampl_max > 0 && nsampl > nsampl_max ? nsampl_max : nsampl;
  fseek(f, meta.data_offset, SEEK_SET);
  if (meta.nch == 1) {
    const size_t got = fread(out, 2, static_cast<size_t>(n), f);
    fclose(f);
    if (got != static_cast<size_t>(n)) return -3;
  } else {
    std::vector<int16_t> raw(static_cast<size_t>(n) * meta.nch);
    const size_t got = fread(raw.data(), 2, raw.size(), f);
    fclose(f);
    if (got != raw.size()) return -3;
    for (int64_t i = 0; i < n; ++i) out[i] = raw[i * meta.nch];
  }
  if (nsampl_out) *nsampl_out = n;
  return 0;
}

int read_one(const char* path, float* out, int nch_want, int64_t nsampl_max,
             int64_t* nsampl_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavMeta meta;
  if (!parse_header(f, &meta)) {
    fclose(f);
    return -2;
  }
  const int64_t nsampl =
      static_cast<int64_t>(meta.data_bytes) / (2 * meta.nch);
  const int64_t n = nsampl_max > 0 && nsampl > nsampl_max ? nsampl_max : nsampl;
  const int nch = nch_want < meta.nch ? nch_want : meta.nch;

  fseek(f, meta.data_offset, SEEK_SET);
  std::vector<int16_t> raw(static_cast<size_t>(n) * meta.nch);
  const size_t got = fread(raw.data(), 2, raw.size(), f);
  fclose(f);
  if (got != raw.size()) return -3;

  constexpr float kScale = 1.0f / 32768.0f;
  for (int c = 0; c < nch; ++c) {
    float* dst = out + static_cast<int64_t>(c) * n;
    for (int64_t i = 0; i < n; ++i) {
      dst[i] = static_cast<float>(raw[i * meta.nch + c]) * kScale;
    }
  }
  if (nsampl_out) *nsampl_out = n;
  return 0;
}

}  // namespace

extern "C" {

int wav_info(const char* path, int64_t* nsampl, int32_t* nch, int32_t* fs) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavMeta meta;
  const bool ok = parse_header(f, &meta);
  fclose(f);
  if (!ok) return -2;
  *nsampl = static_cast<int64_t>(meta.data_bytes) / (2 * meta.nch);
  *nch = meta.nch;
  *fs = static_cast<int32_t>(meta.fs);
  return 0;
}

int wav_read(const char* path, float* out, int32_t nch, int64_t nsampl) {
  int64_t got = 0;
  const int rc = read_one(path, out, nch, nsampl, &got);
  return rc != 0 ? rc : (got == nsampl ? 0 : -4);
}

// Reads channel 0 of n files into a (n, stride) float32 matrix (zero padded),
// storing true lengths in lengths[]; rc[i] per-file status.  Decodes with
// n_threads workers.
int wav_read_batch(const char** paths, int64_t n, float* out, int64_t stride,
                   int64_t* lengths, int32_t* rcs, int32_t n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  std::atomic<int64_t> next(0);
  std::atomic<int> bad(0);
  auto worker = [&]() {
    while (true) {
      const int64_t i = next.fetch_add(1);
      if (i >= n) return;
      float* dst = out + i * stride;
      memset(dst, 0, sizeof(float) * stride);
      int64_t len = 0;
      const int rc = read_one(paths[i], dst, 1, stride, &len);
      lengths[i] = len;
      rcs[i] = rc;
      if (rc != 0) bad.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  const int k = static_cast<int>(n_threads < n ? n_threads : n);
  pool.reserve(k);
  for (int i = 0; i < k; ++i) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return bad.load();
}

// int16 variant of wav_read_batch: (n, stride) int16 matrix, zero padded.
int wav_read_batch_i16(const char** paths, int64_t n, int16_t* out,
                       int64_t stride, int64_t* lengths, int32_t* rcs,
                       int32_t n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  std::atomic<int64_t> next(0);
  std::atomic<int> bad(0);
  auto worker = [&]() {
    while (true) {
      const int64_t i = next.fetch_add(1);
      if (i >= n) return;
      int16_t* dst = out + i * stride;
      memset(dst, 0, sizeof(int16_t) * stride);
      int64_t len = 0;
      const int rc = read_one_i16(paths[i], dst, stride, &len);
      lengths[i] = len;
      rcs[i] = rc;
      if (rc != 0) bad.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  const int k = static_cast<int>(n_threads < n ? n_threads : n);
  pool.reserve(k);
  for (int i = 0; i < k; ++i) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return bad.load();
}

int wav_write(const char* path, const float* data, int64_t nsampl,
              int32_t fs) {
  float peak = 0.0f;
  for (int64_t i = 0; i < nsampl; ++i) {
    const float a = fabsf(data[i]);
    if (a > peak) peak = a;
  }
  const bool norm = peak > 1.0f;

  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const uint32_t data_bytes = static_cast<uint32_t>(nsampl * 2);
  const uint32_t riff_size = 36 + data_bytes;
  const uint16_t fmt = 1, nch = 1, bits = 16, block = 2;
  const uint32_t byte_rate = static_cast<uint32_t>(fs) * 2;
  const uint32_t fmt_size = 16;
  fwrite("RIFF", 1, 4, f);
  fwrite(&riff_size, 4, 1, f);
  fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f);
  fwrite(&fmt_size, 4, 1, f);
  fwrite(&fmt, 2, 1, f);
  fwrite(&nch, 2, 1, f);
  fwrite(&fs, 4, 1, f);
  fwrite(&byte_rate, 4, 1, f);
  fwrite(&block, 2, 1, f);
  fwrite(&bits, 2, 1, f);
  fwrite("data", 1, 4, f);
  fwrite(&data_bytes, 4, 1, f);
  std::vector<int16_t> pcm(nsampl);
  for (int64_t i = 0; i < nsampl; ++i) {
    // divide-then-multiply + truncation toward zero bit-matches the
    // reference's np.int16((x / peak) * 32767) float32 path
    float v = (norm ? data[i] / peak : data[i]) * 32767.0f;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    pcm[i] = static_cast<int16_t>(v);
  }
  fwrite(pcm.data(), 2, pcm.size(), f);
  fclose(f);
  return 0;
}

}  // extern "C"
