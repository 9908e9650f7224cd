// fma_f32.cu — out = a·b + c over f32, rounded once (fmaf), in one launch.
//
// Not a port of a TPU kernel: the single rounding of the reference's
// compiled fleet loop, which contracts a multiply followed by an add into
// one FMA (repro_torch.fma_f32 says where that shows).  The plain PyTorch
// version (repro_torch.fma_f32_reference) computes the product exactly in
// f64 and corrects the f64 sum by its TwoSum error before the cast to f32:
// three or more launches a call.  Here each element is one fmaf, so the
// per-step engines, bound by launches, pay one launch a multiply-add.
//
// Operands: ``b`` a tensor, ``a`` and ``c`` tensors or scalars.  Broadcast
// is carried as strides (0 on a broadcast dimension), never as copies: the
// wrapper coalesces the output's dimensions and passes every operand's
// element strides per dimension.  Bound by bytes: each input element read
// once, each output written once (12–16 bytes an element).  Built without
// fast-math and with -fmad=false (kernels/_build.py); fmaf is the only
// contraction.
#include <cuda_runtime.h>
#include <stdint.h>

#define FMA_MAX_DIMS 8

// The layout of one call, built once per (shapes, strides) by the wrapper.
struct FmaArgs {
  int64_t sizes[FMA_MAX_DIMS];     // output shape, innermost dimension last
  int64_t stride_a[FMA_MAX_DIMS];  // element strides; 0 on broadcast dims
  int64_t stride_b[FMA_MAX_DIMS];
  int64_t stride_c[FMA_MAX_DIMS];
  int32_t ndim;
  int64_t n;                       // output elements
};

__global__ void fma_f32_kernel(const float* __restrict__ a,
                               const float* __restrict__ b,
                               const float* __restrict__ c,
                               float* __restrict__ out, const FmaArgs args,
                               const float a_val, const float c_val) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < args.n; i += step) {
    int64_t rest = i, oa = 0, ob = 0, oc = 0;
    for (int d = args.ndim - 1; d >= 0; --d) {
      const int64_t size = args.sizes[d];
      const int64_t q = rest / size;
      const int64_t k = rest - q * size;
      rest = q;
      oa += k * args.stride_a[d];
      ob += k * args.stride_b[d];
      oc += k * args.stride_c[d];
    }
    const float av = a != nullptr ? a[oa] : a_val;
    const float cv = c != nullptr ? c[oc] : c_val;
    out[i] = fmaf(av, b[ob], cv);
  }
}

// Launch on ``stream``; ``a_val`` / ``c_val`` stand for a null ``a`` /
// ``c``.  Returns cudaGetLastError() (0 on success).
extern "C" int fma_f32_launch(const float* a, const float* b, const float* c,
                              float* out, const FmaArgs* args, float a_val,
                              float c_val, void* stream) {
  if (args->n == 0) return 0;
  if (args->ndim < 1 || args->ndim > FMA_MAX_DIMS) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = 256;
  int64_t blocks = (args->n + threads - 1) / threads;
  // a grid-stride loop past 16 blocks an SM of the 132
  if (blocks > 132 * 16) blocks = 132 * 16;
  fma_f32_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      a, b, c, out, *args, a_val, c_val);
  return (int)cudaGetLastError();
}
