// The OpenMP thread count of the host kernels in this library. PyTorch
// bundles its own OpenMP runtime, so torch.set_num_threads does not reach
// the one g++ links here; native.py passes torch's count through this
// before each call.

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" void maua_native_set_threads(int n) {
#ifdef _OPENMP
  if (n > 0) omp_set_num_threads(n);
#else
  (void)n;
#endif
}
