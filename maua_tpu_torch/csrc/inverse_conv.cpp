// Sequential inverse of emerging (autoregressive masked)
// convolutions, OpenMP-parallel over channels.
//
// C++ rebuild of the reference Cython kernel
// (maua/GAN/training/models/experimental/optstyle/
// inverse_op_cython.pyx:19-67): identical loop nest; raster-order
// back-substitution x = W^{-1} z where W is a masked (upper/lower)
// autoregressive convolution. The channel parallelism is sound for
// masked weights whose cross-channel taps respect the triangular
// ordering (as in the reference).

#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// z, x: (B, H, W, C) float32; w: (K, K, C_in, C_out) float32
void inverse_conv_f32(const float *z, const float *w, float *x,
                      int64_t batch, int64_t height, int64_t width,
                      int64_t channels, int64_t ksize, int is_upper,
                      int dilation) {
    const int64_t kcenter = (ksize - 1) / 2;
    const int64_t hw = height * width;
    std::memset(x, 0, sizeof(float) * batch * hw * channels);

#define X(b, j, i, c) x[(((b)*height + (j)) * width + (i)) * channels + (c)]
#define Z(b, j, i, c) z[(((b)*height + (j)) * width + (i)) * channels + (c)]
#define W(k, m, ci, co) w[(((k)*ksize + (m)) * channels + (ci)) * channels + (co)]

    // NOTE: the reference Cython kernel parallelizes over channels
    // (inverse_op_cython.pyx:33), which races when the center tap has
    // cross-channel entries. We parallelize over the batch instead —
    // correct for any mask — and keep the raster/channel order
    // sequential within each sample.
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < batch; ++b) {
        for (int64_t jj = 0; jj < height; ++jj) {
            const int64_t j = is_upper ? jj : height - jj - 1;
            for (int64_t ii = 0; ii < width; ++ii) {
                const int64_t i = is_upper ? ii : width - ii - 1;
                for (int64_t co_i = 0; co_i < channels; ++co_i) {
                    const int64_t c_out =
                        is_upper ? channels - co_i - 1 : co_i;
                    float acc = 0.0f;
                    for (int64_t c_in = 0; c_in < channels; ++c_in) {
                        for (int64_t k = 0; k < ksize; ++k) {
                            for (int64_t m = 0; m < ksize; ++m) {
                                if (k == kcenter && m == kcenter &&
                                    c_in == c_out)
                                    continue;
                                const int64_t j_ =
                                    j + (k - kcenter) * dilation;
                                const int64_t i_ =
                                    i + (m - kcenter) * dilation;
                                if (j_ < 0 || j_ >= height) continue;
                                if (i_ < 0 || i_ >= width) continue;
                                acc -= W(k, m, c_in, c_out) *
                                       X(b, j_, i_, c_in);
                            }
                        }
                    }
                    acc += Z(b, j, i, c_out);
                    X(b, j, i, c_out) =
                        acc / W(kcenter, kcenter, c_out, c_out);
                }
            }
        }
    }
#undef X
#undef Z
#undef W
}

}  // extern "C"
