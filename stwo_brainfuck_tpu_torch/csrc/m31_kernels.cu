// Elementwise M31 kernels for Hopper (sm_90a): a*b, a*b + c, and the
// chain x <- x*b repeated `chain` times in registers.
//
// Replace the Pallas kernels of stwo_brainfuck_tpu/ops/m31_pallas.py:
// _mul_kernel (behind mul), _mul_add_kernel (behind mul_add) and
// _mul_chain_kernel (behind mul_chain, the M31 throughput measurement).
// Same function, bit for bit: canonical M31 values in and out. The field
// arithmetic is csrc/m31.cuh (one mul.wide.u32, one Mersenne fold, one
// conditional subtract), where the TPU kernels split 16-bit limbs.
//
// What bounds them on the card: device-memory bandwidth. mul and mul_chain
// move 12 bytes per element and mul_add 16; a product costs a handful of
// integer instructions, so even a chain of 8 stays below the byte bound.
// The design does what the bandwidth asks: a grid-stride loop over 16-byte
// vectors (uint4: four elements per thread per step, neighbouring threads on
// neighbouring addresses) and a scalar tail for the last n % 4 elements.
// The constant operand b is loaded once per element and kept in a register
// through the chain (the Pallas body hoists its limb split the same way);
// chain 8, the measured case, is unrolled at compile time.
//
// The wrapper (ops/m31_kernels.py) passes 16-byte aligned, contiguous,
// same-shape int32 buffers and n > 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "m31.cuh"

namespace {

constexpr int kThreads = 256;

struct MulOp {
  __device__ __forceinline__ uint32_t operator()(uint32_t a, uint32_t b, uint32_t) const {
    return m31::mul(a, b);
  }
};

struct MulAddOp {
  __device__ __forceinline__ uint32_t operator()(uint32_t a, uint32_t b, uint32_t c) const {
    return m31::add(m31::mul(a, b), c);
  }
};

// kChain > 0: that many products, unrolled; kChain == 0: `chain` products.
template <int kChain>
struct ChainOp {
  int chain;
  __device__ __forceinline__ uint32_t operator()(uint32_t x, uint32_t b, uint32_t) const {
    if constexpr (kChain > 0) {
#pragma unroll
      for (int k = 0; k < kChain; ++k) x = m31::mul(x, b);
    } else {
      for (int k = 0; k < chain; ++k) x = m31::mul(x, b);
    }
    return x;
  }
};

// out[i] = op(a[i], b[i], c[i]) for i < n; c is read only when kInputs == 3.
template <int kInputs, typename Op>
__global__ void __launch_bounds__(kThreads)
m31_map(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
        const uint32_t* __restrict__ c, uint32_t* __restrict__ out,
        long long n, Op op) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n4 = n >> 2;
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  const uint4* c4 = reinterpret_cast<const uint4*>(c);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  // Both loops stay rolled: every kernel then has the same skeleton and
  // differs only in its products (chip_smoke.py counts one product's SASS
  // from that difference); 8 blocks of 256 threads per SM keep enough
  // 16-byte loads in flight for the bandwidth without unrolling.
#pragma unroll 1
  for (long long i = t; i < n4; i += stride) {
    const uint4 x = a4[i];
    const uint4 y = b4[i];
    uint4 z = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (kInputs == 3) z = c4[i];
    uint4 r;
    r.x = op(x.x, y.x, z.x);
    r.y = op(x.y, y.y, z.y);
    r.z = op(x.z, y.z, z.z);
    r.w = op(x.w, y.w, z.w);
    o4[i] = r;
  }
#pragma unroll 1
  for (long long i = (n4 << 2) + t; i < n; i += stride) {
    uint32_t z = 0u;
    if constexpr (kInputs == 3) z = c[i];
    out[i] = op(a[i], b[i], z);
  }
}

int grid_for(long long n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) sms = 132;
  }
  const long long items = (n >> 2) > 0 ? (n >> 2) : 1;
  const long long blocks = (items + kThreads - 1) / kThreads;
  const long long cap = 8LL * sms;  // 8 resident blocks of 256 threads per SM
  return static_cast<int>(blocks < cap ? blocks : cap);
}

template <int kInputs, typename Op>
int launch(const void* a, const void* b, const void* c, void* out, long long n,
           Op op, void* stream) {
  m31_map<kInputs, Op><<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint32_t*>(c), static_cast<uint32_t*>(out), n, op);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch (0 = launched).

extern "C" int m31_mul(const void* a, const void* b, void* out, long long n, void* stream) {
  return launch<2>(a, b, nullptr, out, n, MulOp{}, stream);
}

extern "C" int m31_mul_add(const void* a, const void* b, const void* c, void* out,
                           long long n, void* stream) {
  return launch<3>(a, b, c, out, n, MulAddOp{}, stream);
}

extern "C" int m31_mul_chain(const void* a, const void* b, void* out, long long n,
                             int chain, void* stream) {
  if (chain == 8) return launch<2>(a, b, nullptr, out, n, ChainOp<8>{8}, stream);
  return launch<2>(a, b, nullptr, out, n, ChainOp<0>{chain}, stream);
}
