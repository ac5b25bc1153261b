// The native mel reader of the PyTorch port's data loader (a copy of the
// JAX package's native/tts_data.cpp, kept inside the port so that the port
// builds its own library and loads nothing of the JAX package).
//
//   * HTK reader: 12-byte big-endian header + float32 frame matrix with
//     byte swapping, fused with mean/var normalization in one pass.
//   * npy (v1.0/2.0, C-order float32/float64) reader fused with
//     normalization.
//   * tts_load_mel_batch: N threads load and normalize a whole batch of
//     mels into one (B, max_len, D) buffer in a single call, so the Python
//     loader releases the GIL once per batch.
//
// Build: transformer_tts_tpu_torch/data/native.py compiles this file with
// the host's c++ (-O3 -shared -fPIC -pthread) into build/tts_data/ at its
// first use and binds it with ctypes.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <thread>
#include <vector>

namespace {

inline uint32_t swap32(uint32_t v) {
#if defined(__GNUC__)
    return __builtin_bswap32(v);
#else
    return ((v & 0xFF) << 24) | ((v & 0xFF00) << 8) |
           ((v >> 8) & 0xFF00) | (v >> 24);
#endif
}

inline uint16_t swap16(uint16_t v) {
    return (uint16_t)((v << 8) | (v >> 8));
}

}  // namespace

extern "C" {

// Parse an HTK file. Writes up to max_frames * out_dim floats into `out`
// (row-major, truncating the per-frame vector to out_dim, matching the
// reference's [:, :mel_dim] slice). Optional mean/var normalization
// ((x - mean) / sqrt(var)) applied in the same pass when mean != nullptr.
// Returns the number of frames written, or -1 on error.
int tts_load_htk(const char* path, float* out, int max_frames, int out_dim,
                 const float* mean, const float* var) {
    FILE* fh = std::fopen(path, "rb");
    if (!fh) return -1;
    uint8_t header[12];
    if (std::fread(header, 1, 12, fh) != 12) { std::fclose(fh); return -1; }
    uint16_t samp_size;
    std::memcpy(&samp_size, header + 8, 2);
    samp_size = swap16(samp_size);
    int veclen = samp_size / 4;
    if (veclen <= 0) { std::fclose(fh); return -1; }
    int dim = out_dim < veclen ? out_dim : veclen;

    float* row = (float*)std::malloc(sizeof(float) * veclen);
    int frames = 0;
    while (frames < max_frames) {
        size_t got = std::fread(row, sizeof(float), veclen, fh);
        if (got != (size_t)veclen) break;
        uint32_t* bits = (uint32_t*)row;
        float* dst = out + (size_t)frames * out_dim;
        for (int j = 0; j < dim; ++j) {
            uint32_t s = swap32(bits[j]);
            float v;
            std::memcpy(&v, &s, 4);
            if (mean) v = (v - mean[j]) / std::sqrt(var[j]);
            dst[j] = v;
        }
        for (int j = dim; j < out_dim; ++j) dst[j] = 0.0f;
        ++frames;
    }
    std::free(row);
    std::fclose(fh);
    return frames;
}

// Minimal .npy reader for C-order float32/float64 2-D arrays, fused with
// normalization. Returns frames written, -1 on error, -2 on unsupported
// format (the caller reads that file with numpy).
int tts_load_npy(const char* path, float* out, int max_frames, int out_dim,
                 const float* mean, const float* var) {
    FILE* fh = std::fopen(path, "rb");
    if (!fh) return -1;
    uint8_t magic[8];
    if (std::fread(magic, 1, 8, fh) != 8 ||
        std::memcmp(magic, "\x93NUMPY", 6) != 0) {
        std::fclose(fh);
        return -2;
    }
    int major = magic[6];
    uint32_t header_len = 0;
    if (major == 1) {
        uint16_t hl;
        if (std::fread(&hl, 2, 1, fh) != 1) { std::fclose(fh); return -2; }
        header_len = hl;
    } else {
        if (std::fread(&header_len, 4, 1, fh) != 1) {
            std::fclose(fh); return -2;
        }
    }
    char* header = (char*)std::malloc(header_len + 1);
    if (std::fread(header, 1, header_len, fh) != header_len) {
        std::free(header); std::fclose(fh); return -2;
    }
    header[header_len] = 0;

    bool f64 = std::strstr(header, "'<f8'") != nullptr;
    bool f32 = std::strstr(header, "'<f4'") != nullptr;
    bool fortran = std::strstr(header, "'fortran_order': True") != nullptr;
    const char* shp = std::strstr(header, "'shape': (");
    long rows = 0, cols = 0;
    if (shp) {
        shp += 10;
        rows = std::strtol(shp, (char**)&shp, 10);
        while (*shp == ',' || *shp == ' ') ++shp;
        cols = std::strtol(shp, nullptr, 10);
    }
    std::free(header);
    if ((!f32 && !f64) || fortran || rows <= 0) {
        std::fclose(fh);
        return -2;
    }
    if (cols == 0) cols = 1;                 // 1-D array
    // require exact width: ragged/transposed layouts fall back to the
    // numpy path, which reproduces the reference's reshape semantics
    if (cols != out_dim) { std::fclose(fh); return -2; }

    long frames = rows < max_frames ? rows : max_frames;
    size_t elem = f64 ? 8 : 4;
    size_t count = (size_t)frames * cols;
    // bulk read (one fread for the whole matrix — a per-row loop is
    // slower than numpy's single blob read), then normalize in place
    if (f64) {
        double* tmp = (double*)std::malloc(sizeof(double) * count);
        size_t got = std::fread(tmp, elem, count, fh);
        frames = (long)(got / cols);
        for (long i = 0; i < frames; ++i) {
            float* dst = out + (size_t)i * out_dim;
            const double* src = tmp + (size_t)i * cols;
            for (int j = 0; j < out_dim; ++j) {
                float v = (float)src[j];
                if (mean) v = (v - mean[j]) / std::sqrt(var[j]);
                dst[j] = v;
            }
        }
        std::free(tmp);
    } else {
        size_t got = std::fread(out, elem, count, fh);
        frames = (long)(got / cols);
        if (mean) {
            // divide (not reciprocal-multiply): bit-identical to the
            // numpy path's (x - mean) / sqrt(var)
            float sq[1024];
            int d = out_dim < 1024 ? out_dim : 1024;
            for (int j = 0; j < d; ++j) sq[j] = std::sqrt(var[j]);
            for (long i = 0; i < frames; ++i) {
                float* dst = out + (size_t)i * out_dim;
                for (int j = 0; j < d; ++j)
                    dst[j] = (dst[j] - mean[j]) / sq[j];
            }
        }
    }
    std::fclose(fh);
    return (int)frames;
}

// Pad a ragged batch of mel buffers into one (batch, max_len, dim) buffer.
// mels: array of pointers to (lengths[i], dim) row-major float32 buffers.
void tts_pad_mel_batch(const float** mels, const int* lengths, int batch,
                       int max_len, int dim, float pad, float* out) {
    for (int b = 0; b < batch; ++b) {
        float* dst = out + (size_t)b * max_len * dim;
        int n = lengths[b] < max_len ? lengths[b] : max_len;
        std::memcpy(dst, mels[b], sizeof(float) * (size_t)n * dim);
        float* tail = dst + (size_t)n * dim;
        size_t count = (size_t)(max_len - n) * dim;
        for (size_t k = 0; k < count; ++k) tail[k] = pad;
    }
}

// Assemble a whole padded batch in one call: N worker threads each load
// (npy or HTK, auto-detected), normalize, and write DIRECTLY into the
// caller's (batch, max_len, dim) buffer, then pad-fill the tail — one
// GIL release for the entire batch instead of one ctypes round trip per
// utterance. lengths_out[i] receives the true frame count (clamped to
// max_len), or -1 if utterance i failed (the caller reads it with numpy).
// fill_tail=0 skips padding rows past the loaded frames — callers that
// re-collate into their own padded buffer (the data layer) avoid
// touching the probe buffer's (large) tail.
void tts_load_mel_batch(const char** paths, int batch, float* out,
                        int max_len, int dim, float pad,
                        const float* mean, const float* var,
                        int n_threads, int* lengths_out, int fill_tail) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > batch) n_threads = batch;
    std::atomic<int> next(0);
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= batch) return;
            float* dst = out + (size_t)i * max_len * dim;
            const char* p = paths[i];
            int n = -1;
            if (std::strstr(p, ".htk")) {
                n = tts_load_htk(p, dst, max_len, dim, mean, var);
            } else {
                n = tts_load_npy(p, dst, max_len, dim, mean, var);
            }
            lengths_out[i] = n;
            if (fill_tail || n < 0) {
                int start = n < 0 ? 0 : n;
                float* tail = dst + (size_t)start * dim;
                size_t count = (size_t)(max_len - start) * dim;
                for (size_t k = 0; k < count; ++k) tail[k] = pad;
            }
        }
    };
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
}

}  // extern "C"
