// The process mesh's elementwise M31 stages for Hopper (sm_90a), in place on
// a shard's int32 buffer: the sharded circle FFT's cross-shard butterflies
// (parallel/fft_sharded.py) and the composition's per-size sum
// (parallel/prove.py, ShardedOps._add).
//
// A cross stage pairs shard i with shard i ^ dist; every position of a
// shard shares one twiddle c, so a stage is a map over the shard's own
// column x and the partner's column y (received into one reused buffer):
//
//   EvalLower    out = x + c·y        the evaluate's lower shard
//   EvalUpper    out = y − c·x        the evaluate's upper shard
//   Add          out = x + y          the interpolate's lower shard; the sum
//   AddScaled    out = (x + y)·c      the interpolate's last lower stage, c = 2^-n
//   SubMul       out = (y − x)·c      the interpolate's upper shard, c = t^-1
//                                     (times 2^-n in the last stage)
//
// Canonical values in and out; the arithmetic is csrc/m31.cuh's, so a
// product is widened to 64 bits only in registers. `out` may be `x` (the
// stage in place) and is written once a position after both reads.
//
// What bounds it: device-memory bandwidth, 12 bytes a position (x and y
// read, out written) against one product. The design is the M31 kernels'
// (csrc/m31_kernels.cu): a grid-stride loop over 16-byte vectors, 8 blocks
// of 256 threads an SM, a scalar tail, and the scalar loop alone where a
// pointer is not 16-byte aligned (a column view at an odd offset, small
// shapes only).

#include <cstdint>
#include <cuda_runtime.h>

#include "m31.cuh"

namespace {

constexpr int kThreads = 256;

enum Op : int { kEvalLower = 0, kEvalUpper = 1, kAdd = 2, kAddScaled = 3, kSubMul = 4 };

template <int kOp>
__device__ __forceinline__ uint32_t stage(uint32_t x, uint32_t y, uint32_t c) {
  if constexpr (kOp == kEvalLower) return m31::add(x, m31::mul(c, y));
  if constexpr (kOp == kEvalUpper) return m31::sub(y, m31::mul(c, x));
  if constexpr (kOp == kAdd) return m31::add(x, y);
  if constexpr (kOp == kAddScaled) return m31::mul(m31::add(x, y), c);
  return m31::mul(m31::sub(y, x), c);
}

template <int kOp>
__global__ void __launch_bounds__(kThreads)
mesh_cross_kernel(const uint32_t* x, const uint32_t* __restrict__ y, uint32_t* out,
                  long long n, uint32_t c, int vectors) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vectors) {
    const long long n4 = n >> 2;
    const uint4* x4 = reinterpret_cast<const uint4*>(x);
    const uint4* y4 = reinterpret_cast<const uint4*>(y);
    uint4* o4 = reinterpret_cast<uint4*>(out);
#pragma unroll 1
    for (long long i = t; i < n4; i += stride) {
      const uint4 a = x4[i];
      const uint4 b = y4[i];
      uint4 r;
      r.x = stage<kOp>(a.x, b.x, c);
      r.y = stage<kOp>(a.y, b.y, c);
      r.z = stage<kOp>(a.z, b.z, c);
      r.w = stage<kOp>(a.w, b.w, c);
      o4[i] = r;
    }
    done = n4 << 2;
  }
#pragma unroll 1
  for (long long i = done + t; i < n; i += stride) out[i] = stage<kOp>(x[i], y[i], c);
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
  const long long cap = 8LL * sms;  // 8 resident blocks of 256 threads an SM
  return static_cast<int>(blocks < cap ? blocks : cap);
}

template <int kOp>
void launch(const void* x, const void* y, void* out, long long n, uint32_t c, int vectors,
            cudaStream_t stream) {
  mesh_cross_kernel<kOp><<<grid_for(n), kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y),
      static_cast<uint32_t*>(out), n, c, vectors);
}

}  // namespace

// One stage over n positions: out[k] = op(x[k], y[k], c). `vectors` = 1
// where x, y and out all start on 16 bytes. Returns cudaGetLastError()
// after the launch (0 = launched), or -1 for an unknown op.
extern "C" int mesh_cross(const void* x, const void* y, void* out, long long n, uint32_t c,
                          int op, int vectors, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kEvalLower: launch<kEvalLower>(x, y, out, n, c, vectors, s); break;
    case kEvalUpper: launch<kEvalUpper>(x, y, out, n, c, vectors, s); break;
    case kAdd: launch<kAdd>(x, y, out, n, c, vectors, s); break;
    case kAddScaled: launch<kAddScaled>(x, y, out, n, c, vectors, s); break;
    case kSubMul: launch<kSubMul>(x, y, out, n, c, vectors, s); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
