// Native IQ sample-format conversion for the host ingest hot loop.
//
// Accelerator-native replacement for the sample conversion the reference delegates to
// the SDR++ host application's source modules (the plugin itself consumes an
// already-converted float stream, src/main.cpp:55-60). Converting multi-MS/s
// int8/int16 interleaved IQ to complex64 is the one host-side per-sample loop
// in this framework, so it is done in C++ (auto-vectorized) rather than
// Python. Loaded via ctypes from sondetpu/io/iq.py.

#include <cstddef>
#include <cstdint>

extern "C" {

void iq_cs16_to_cf32(const int16_t *src, float *dst, size_t n_complex,
                     float scale) {
  const size_t n = n_complex * 2;
  for (size_t i = 0; i < n; ++i) {
    dst[i] = static_cast<float>(src[i]) * scale;
  }
}

void iq_cs8_to_cf32(const int8_t *src, float *dst, size_t n_complex,
                    float scale) {
  const size_t n = n_complex * 2;
  for (size_t i = 0; i < n; ++i) {
    dst[i] = static_cast<float>(src[i]) * scale;
  }
}

void iq_cu8_to_cf32(const uint8_t *src, float *dst, size_t n_complex,
                    float scale) {
  const size_t n = n_complex * 2;
  for (size_t i = 0; i < n; ++i) {
    dst[i] = (static_cast<float>(src[i]) - 127.5f) * scale;
  }
}

// Deinterleave complex64 (interleaved float I,Q) into separate I/Q planes.
// The per-block host hot loop feeding the device pipeline: the compiled
// programs take split float32 planes, so every ingested block passes
// through here.
void iq_c64_to_planes(const float *src, float *dst_i, float *dst_q,
                      size_t n_complex) {
  for (size_t k = 0; k < n_complex; ++k) {
    dst_i[k] = src[2 * k];
    dst_q[k] = src[2 * k + 1];
  }
}

// Fused cs16 -> planes (network/file ingest straight to pipeline layout).
void iq_cs16_to_planes(const int16_t *src, float *dst_i, float *dst_q,
                       size_t n_complex, float scale) {
  for (size_t k = 0; k < n_complex; ++k) {
    dst_i[k] = static_cast<float>(src[2 * k]) * scale;
    dst_q[k] = static_cast<float>(src[2 * k + 1]) * scale;
  }
}

}  // extern "C"
