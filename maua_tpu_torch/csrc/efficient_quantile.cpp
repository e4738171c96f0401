// Efficient multi-quantile via recursive partial sorting.
//
// TPU-native rebuild of the reference torch extension
// (maua/audiovisual/audioreactive/selfsupervised/features/
// efficient_quantile/efficient_quantile.cpp:8-206): the same recursive
// std::nth_element strategy — O(n log q) instead of a full sort — for
// host-side quantiles of huge envelope tensors, exposed through a
// plain C ABI (ctypes) instead of pybind11/torch.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

template <class T>
void recursive_partial_sorter(T *data, int64_t start, int64_t size,
                              const int64_t *qidx, int64_t qsize) {
    if (size <= 0 || qsize <= 0) return;
    if (qsize == 1) {
        std::nth_element(data + start, data + qidx[0], data + start + size);
        return;
    }
    int64_t center = qsize / 2;
    int64_t pivot = qidx[center];
    std::nth_element(data + start, data + pivot, data + start + size);
    int64_t lower_size = pivot - start;
    int64_t upper_size = size - lower_size;
    if (center > 0)
        recursive_partial_sorter(data, start, lower_size, qidx, center);
    if (qsize - center > 1)
        recursive_partial_sorter(data, pivot, upper_size, qidx + center,
                                 qsize - center);
}

}  // namespace

extern "C" {

// data: mutable scratch copy of the values (length n)
// qs:   ascending quantiles in [0, 1] (length nq)
// out:  nq interpolated quantile values
// Returns 0 on success.
int efficient_quantile_f32(float *data, int64_t n, const double *qs,
                           int64_t nq, double *out, int ignore_nan) {
    if (n <= 0 || nq <= 0) return 1;

    int64_t effective_n = n;
    if (ignore_nan) {
        // push NaNs to the end
        int64_t j = 0;
        for (int64_t i = 0; i < n; ++i) {
            if (!std::isnan(data[i])) data[j++] = data[i];
        }
        effective_n = j;
        if (effective_n == 0) return 2;
    }

    // linear interpolation indices: pos = q * (n - 1)
    std::vector<int64_t> idx;
    std::vector<int64_t> idx_hi;
    std::vector<double> frac(nq);
    for (int64_t i = 0; i < nq; ++i) {
        double pos = qs[i] * (double)(effective_n - 1);
        int64_t lo = (int64_t)pos;
        if (lo < 0) lo = 0;
        if (lo > effective_n - 1) lo = effective_n - 1;
        int64_t hi = std::min<int64_t>(lo + 1, effective_n - 1);
        frac[i] = pos - (double)lo;
        idx.push_back(lo);
        idx_hi.push_back(hi);
    }

    // union of needed order statistics, ascending + unique
    std::vector<int64_t> all(idx);
    all.insert(all.end(), idx_hi.begin(), idx_hi.end());
    std::sort(all.begin(), all.end());
    all.erase(std::unique(all.begin(), all.end()), all.end());

    recursive_partial_sorter(data, 0, effective_n, all.data(),
                             (int64_t)all.size());

    for (int64_t i = 0; i < nq; ++i) {
        double lo = (double)data[idx[i]];
        double hi = (double)data[idx_hi[i]];
        out[i] = lo + (hi - lo) * frac[i];
    }
    return 0;
}

// kth smallest value (the reference's kthvalue-style percentile,
// audioreactive/signal.py:41-53)
float kthvalue_f32(float *data, int64_t n, int64_t k) {
    if (k < 1) k = 1;
    if (k > n) k = n;
    std::nth_element(data, data + (k - 1), data + n);
    return data[k - 1];
}

}  // extern "C"
