// Native batch-ingest kernels for the host-side data path of the PyTorch
// port (a copy of motionstyle/native/src/ingest.cc; the port builds and
// loads its own library).
//
// The reference feeds its training loop through torch's DataLoader
// (data_loaders/get_data.py:43-53 — native worker processes + C collate);
// this is our equivalent: the per-batch hot path between dataset memory and
// the device transfer — window crop, z-normalization, zero-padding,
// (T, C) -> (C, 1, T) transpose and batch stacking — fused into one
// multithreaded C++ pass writing the final (B, C, 1, T) buffer that the
// trainer copies to the device. Python keeps the cheap per-item sampling
// decisions (caption choice, window RNG) so randomness semantics stay
// identical to the pure-numpy loader (data/collate.py).
//
// Build: g++ -O3 -march=native -shared -fPIC (motionstyle_torch/native/build.py).
// No Python.h — bound via ctypes on plain pointers.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {

// One item: crop rows [start, start+m_len) of a row-major (len, C) f32
// motion, normalize per channel, transpose into out as (C, T) with zero
// padding for t >= m_len.
void ingest_item(const float* motion, int64_t start, int64_t m_len,
                 int64_t C, int64_t T, const float* mean,
                 const float* inv_std, float* out) {
  for (int64_t t = 0; t < m_len; ++t) {
    const float* row = motion + (start + t) * C;
    // contiguous read of the source row; stride-T writes per channel
    for (int64_t c = 0; c < C; ++c) {
      out[c * T + t] = (row[c] - mean[c]) * inv_std[c];
    }
  }
  if (m_len < T) {
    for (int64_t c = 0; c < C; ++c) {
      std::fill(out + c * T + m_len, out + (c + 1) * T, 0.0f);
    }
  }
}

}  // namespace

extern "C" {

// motions: B pointers to row-major (len_b, C) float32 arrays.
// starts/m_lens: per-item crop start and kept length (m_len <= T).
// out: (B, C, 1, T) float32, contiguous. nthreads <= 0 -> hardware count.
void msn_window_normalize_collate(const float** motions, const int64_t* starts,
                                  const int64_t* m_lens, int64_t B, int64_t C,
                                  int64_t T, const float* mean,
                                  const float* inv_std, float* out,
                                  int32_t nthreads) {
  int n = nthreads > 0 ? nthreads
                       : static_cast<int>(std::thread::hardware_concurrency());
  n = std::max(1, std::min<int>(n, static_cast<int>(B)));
  if (n == 1) {
    for (int64_t b = 0; b < B; ++b) {
      ingest_item(motions[b], starts[b], m_lens[b], C, T, mean, inv_std,
                  out + b * C * T);
    }
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(n);
  for (int w = 0; w < n; ++w) {
    workers.emplace_back([=]() {
      for (int64_t b = w; b < B; b += n) {
        ingest_item(motions[b], starts[b], m_lens[b], C, T, mean, inv_std,
                    out + b * C * T);
      }
    });
  }
  for (auto& t : workers) t.join();
}

// Whitespace-separated float parsing for BVH MOTION tables (BVH readers):
// one strtof pass over the raw text, no per-token Python string objects.
// Returns the number of floats written (<= cap).
int64_t msn_parse_floats(const char* text, int64_t len, float* out,
                         int64_t cap) {
  const char* p = text;
  const char* end = text + len;
  int64_t n = 0;
  while (p < end && n < cap) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) {
      ++p;
    }
    if (p >= end) break;
    char* next = nullptr;
    float v = strtof(p, &next);
    if (next == p) break;  // non-numeric garbage: stop (caller validates count)
    out[n++] = v;
    p = next;
  }
  return n;
}

// Batch mask build: out (B, 1, 1, T) f32, 1.0 where t < length[b].
// (lengths_to_mask in data/collate.py:15, done natively alongside collate.)
void msn_lengths_to_mask(const int64_t* lengths, int64_t B, int64_t T,
                         float* out) {
  for (int64_t b = 0; b < B; ++b) {
    int64_t m = std::min(lengths[b], T);
    std::fill(out + b * T, out + b * T + m, 1.0f);
    std::fill(out + b * T + m, out + (b + 1) * T, 0.0f);
  }
}

}  // extern "C"
