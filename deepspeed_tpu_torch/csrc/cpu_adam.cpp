// Host-side vectorized optimizers for ZeRO-Offload and ZeRO-Infinity.
//
// The port's own copy of the JAX package's host library
// (deepspeed_tpu/ops/csrc/cpu_adam.cpp): the same code under the same
// g++ flags (ops/build.py GXX_FLAGS), so both packages' sweeps give the
// same bits.  fp32 master params and moments live in host memory; the
// device keeps only compute-dtype params.
//   - Plain loops + OpenMP `parallel for simd` let the compiler emit
//     AVX/NEON for the host CPU (-O3 -march=native).
//   - The bf16 device copy is produced in the same pass, so offload costs
//     one sweep per step.
//   - grad_scale folds loss-scale, microbatch normalization and the clip
//     factor into one multiply.
//
// Exposed as a plain C ABI for ctypes (ops/adam/cpu_adam.py).

#include <cmath>
#include <cstdint>
#include <cstring>

static inline uint16_t f32_to_bf16(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    // round-to-nearest-even on the dropped 16 bits
    uint32_t lsb = (x >> 16) & 1u;
    x += 0x7fffu + lsb;
    return (uint16_t)(x >> 16);
}

extern "C" {

// AdamW / Adam step over a flat buffer.
//   p, m, v : fp32 master param + moments (updated in place)
//   g       : fp32 gradient (summed; divided by grad_scale here)
//   step    : 1-based step count for bias correction
//   adamw   : nonzero = decoupled weight decay; 0 = L2 into the gradient
//   out_bf16: optional bf16 copy of the updated params (device upload)
void ds_adam_step(int64_t n, float* p, float* m, float* v, const float* g,
                  float lr, float beta1, float beta2, float eps,
                  float weight_decay, int step, float grad_scale,
                  int adamw, uint16_t* out_bf16) {
    const float c1 = 1.0f - powf(beta1, (float)step);
    const float c2 = 1.0f - powf(beta2, (float)step);
    const float inv_scale = 1.0f / grad_scale;
#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float grad = g[i] * inv_scale;
        if (!adamw && weight_decay != 0.0f) grad += weight_decay * p[i];
        float mi = beta1 * m[i] + (1.0f - beta1) * grad;
        float vi = beta2 * v[i] + (1.0f - beta2) * grad * grad;
        m[i] = mi;
        v[i] = vi;
        float u = (mi / c1) / (sqrtf(vi / c2) + eps);
        if (adamw && weight_decay != 0.0f) u += weight_decay * p[i];
        p[i] -= lr * u;
        if (out_bf16) out_bf16[i] = f32_to_bf16(p[i]);
    }
}

// Adam step with bf16 gradients straight off the wire (the ZeRO-Infinity
// grad stream is bf16 — converting inline saves a full host pass, which
// matters on single-core TPU-VM hosts).
void ds_adam_step_g16(int64_t n, float* p, float* m, float* v,
                      const uint16_t* g16, float lr, float beta1, float beta2,
                      float eps, float weight_decay, int step,
                      float grad_scale, int adamw, uint16_t* out_bf16) {
    const float c1 = 1.0f - powf(beta1, (float)step);
    const float c2 = 1.0f - powf(beta2, (float)step);
    const float inv_scale = 1.0f / grad_scale;
#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        uint32_t gbits = ((uint32_t)g16[i]) << 16;
        float grad;
        std::memcpy(&grad, &gbits, 4);
        grad *= inv_scale;
        if (!adamw && weight_decay != 0.0f) grad += weight_decay * p[i];
        float mi = beta1 * m[i] + (1.0f - beta1) * grad;
        float vi = beta2 * v[i] + (1.0f - beta2) * grad * grad;
        m[i] = mi;
        v[i] = vi;
        float u = (mi / c1) / (sqrtf(vi / c2) + eps);
        if (adamw && weight_decay != 0.0f) u += weight_decay * p[i];
        p[i] -= lr * u;
        if (out_bf16) out_bf16[i] = f32_to_bf16(p[i]);
    }
}

// Accumulate bf16 wire gradients into an fp32 buffer (gradient
// accumulation across microbatches in the collect path).
void ds_accum_g16(int64_t n, float* acc, const uint16_t* g16) {
#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        uint32_t gbits = ((uint32_t)g16[i]) << 16;
        float grad;
        std::memcpy(&grad, &gbits, 4);
        acc[i] += grad;
    }
}

// Adagrad step (reference csrc/adagrad/cpu_adagrad.cpp).
void ds_adagrad_step(int64_t n, float* p, float* sq, const float* g,
                     float lr, float eps, float weight_decay,
                     float grad_scale, uint16_t* out_bf16) {
    const float inv_scale = 1.0f / grad_scale;
#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float grad = g[i] * inv_scale;
        if (weight_decay != 0.0f) grad += weight_decay * p[i];
        float s = sq[i] + grad * grad;
        sq[i] = s;
        p[i] -= lr * grad / (sqrtf(s) + eps);
        if (out_bf16) out_bf16[i] = f32_to_bf16(p[i]);
    }
}

// fp32 -> bf16 buffer conversion (device upload of untouched leaves).
void ds_f32_to_bf16(int64_t n, const float* src, uint16_t* dst) {
#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) dst[i] = f32_to_bf16(src[i]);
}

}  // extern "C"
