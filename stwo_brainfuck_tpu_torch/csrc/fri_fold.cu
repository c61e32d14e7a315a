// The FRI folds from one committed layer to the next in one launch, for
// Hopper (sm_90a): int32 in, int32 out.
//
// Replaces stwo_brainfuck_tpu/core/fri.py:67 _fold_jit, :77 _fold2_jit and
// :85 _fold_add_jit (jnp that XLA fuses; not Pallas). The port's plain
// version is core/fri.py fold_step_plain (the int64 _fold), bit for bit.
//
// A fold of a QM31 evaluation over adjacent pairs (bit-reversed storage):
//
//   fold(a, b, itw, beta) = (a + b) / 2 + beta (a - b) itw,
//
// itw = 1 / (2 y_t) for the circle fold of pair t, 1 / (2 x_t) for a line
// fold. One launch computes, for output position t (of n, the output a
// chunk of its layer on a mesh shard):
//
//   folds 0:  x = src[t]
//   folds 1:  x = fold(src[2t], src[2t + 1], i1[t], beta)
//   folds 2:  u_k = fold(src[4t + 2k], src[4t + 2k + 1], i1[2t + k], beta)
//                   (+ fold(A[4t + 2k], A[4t + 2k + 1], ia[2t + k], beta0))
//             x = fold(u_0, u_1, i2[t], beta2)
//   then      out[t] = x (+ fold(B[2t], B[2t + 1], ib[t], beta0))
//
// A and B are the injected circle inputs (core/fri.py FoldStep): A the one
// that lands between two folds, B the one at the output level. Every
// array is (4, m) int32, its rows `stride` words apart.
//
// Twiddles: each of i1, ia, i2, ib points at the twiddle of the chunk's
// pair 0 (the wrapper adds the chunk's offset) in the circle FFT's doubled
// twiddles 2 y_t / 2 x_t (its int32 tables, ops/circle_fft.twiddle_table,
// which every prove already holds on the card), reduced mod p and inverted
// here: all the twiddles of a thread's K outputs in one batch
// (qm31::batch_inv, Montgomery's trick: one m31_inv and three products a
// twiddle). Any exact inverse gives the same words. Int32 inverse tables
// of their own (tools/fold_variants.py builds that variant) are at most
// 13 % faster a launch on an H100 but hold 0.5 GiB at the 2^28-position
// circle fold, built on the card at a cold prove.
//
// Indices are 32-bit: the largest word a launch reads is 4 n - 1 (two
// folds) or 2 n - 1, so fri_fold refuses n << max(folds, 1) > 2^32.
//
// Schedule (ops/fri_kernels.py emulate replays it): K = 4 outputs a thread,
// t0 + i S for i < K (S = ceil(n / K)), so each of a thread's loads and
// stores is coalesced across the warp.
//
// What bounds it: its bytes (each input word read once, the output written
// once: 52 bytes an output of the circle fold). On an H100 the 2^28-position
// circle fold of a production prove runs at 90 % of that bound and the
// 2^27 -> 2^25 step at 79 % (chip_smoke.py's oods_fri line); steps of fewer
// than about 2^18 outputs take one launch's latency (5-12 us).

#include <cstdint>
#include <cuda_runtime.h>

#include "m31.cuh"
#include "qm31.cuh"

namespace {

using qm31::Qm;

constexpr int kThreads = 256;
constexpr int kK = 4;
constexpr uint32_t kInv2 = (m31::kP + 1u) / 2u;

struct Args {
  const uint32_t* src;
  long long src_stride;
  const uint32_t* inj_a;
  long long a_stride;
  const uint32_t* inj_b;
  long long b_stride;
  const uint32_t* i1;
  const uint32_t* ia;
  const uint32_t* i2;
  const uint32_t* ib;
  Qm beta, beta2, beta0;
  uint32_t n;
  uint32_t stride;  // S
  uint32_t* out;    // (4, n)
};

__device__ __forceinline__ Qm load(const uint32_t* p, long long stride, uint32_t i) {
  return {__ldg(p + i), __ldg(p + stride + i), __ldg(p + 2 * stride + i),
          __ldg(p + 3 * stride + i)};
}

__device__ __forceinline__ Qm fold(Qm x, Qm y, uint32_t itw, Qm beta) {
  const Qm s = qm31::qm_mul_m31(qm31::qm_add(x, y), kInv2);
  const Qm d = qm31::qm_mul_m31(qm31::qm_sub(x, y), itw);
  return qm31::qm_add(s, qm31::qm_mul(beta, d));
}

// The twiddles an output reads: fold 1 (two with two folds), A's two, fold
// 2's, B's.
template <int NF, bool kA, bool kB>
__host__ __device__ constexpr int twiddles() {
  return (NF == 2 ? 2 : NF) + (kA ? 2 : 0) + (NF == 2 ? 1 : 0) + (kB ? 1 : 0);
}

template <int NF, bool kA, bool kB>
__global__ void __launch_bounds__(kThreads) fold_kernel(const Args a) {
  constexpr int kT = twiddles<NF, kA, kB>();
  const uint32_t t0 = blockIdx.x * kThreads + threadIdx.x;
  if (t0 >= a.stride) return;
  uint32_t tw[kK * kT];
#pragma unroll
  for (int m = 0; m < kK; ++m) {
    const uint32_t t = t0 + m * a.stride;
    const bool live = t < a.n;
    int j = m * kT;
    if (NF == 1) tw[j++] = live ? __ldg(a.i1 + t) : 0u;
    if (NF == 2) {
      tw[j++] = live ? __ldg(a.i1 + 2 * t) : 0u;
      tw[j++] = live ? __ldg(a.i1 + 2 * t + 1) : 0u;
    }
    if (kA) {
      tw[j++] = live ? __ldg(a.ia + 2 * t) : 0u;
      tw[j++] = live ? __ldg(a.ia + 2 * t + 1) : 0u;
    }
    if (NF == 2) tw[j++] = live ? __ldg(a.i2 + t) : 0u;
    if (kB) tw[j++] = live ? __ldg(a.ib + t) : 0u;
  }
  uint32_t z[kK * kT];
#pragma unroll
  for (int j = 0; j < kK * kT; ++j) z[j] = m31::reduce_once(tw[j]);  // 2 t < 2p
  qm31::batch_inv<kK * kT>(z, tw);
#pragma unroll
  for (int m = 0; m < kK; ++m) {
    const uint32_t t = t0 + m * a.stride;
    if (t >= a.n) continue;
    int j = m * kT;
    Qm x;
    if (NF == 0) x = load(a.src, a.src_stride, t);
    if (NF == 1) x = fold(load(a.src, a.src_stride, 2 * t), load(a.src, a.src_stride, 2 * t + 1),
                          tw[j++], a.beta);
    if (NF == 2) {
      Qm u0 = fold(load(a.src, a.src_stride, 4 * t), load(a.src, a.src_stride, 4 * t + 1),
                   tw[j], a.beta);
      Qm u1 = fold(load(a.src, a.src_stride, 4 * t + 2), load(a.src, a.src_stride, 4 * t + 3),
                   tw[j + 1], a.beta);
      j += 2;
      if (kA) {
        u0 = qm31::qm_add(u0, fold(load(a.inj_a, a.a_stride, 4 * t),
                                   load(a.inj_a, a.a_stride, 4 * t + 1), tw[j], a.beta0));
        u1 = qm31::qm_add(u1, fold(load(a.inj_a, a.a_stride, 4 * t + 2),
                                   load(a.inj_a, a.a_stride, 4 * t + 3), tw[j + 1], a.beta0));
        j += 2;
      }
      x = fold(u0, u1, tw[j++], a.beta2);
    }
    if (kB) x = qm31::qm_add(x, fold(load(a.inj_b, a.b_stride, 2 * t),
                                     load(a.inj_b, a.b_stride, 2 * t + 1), tw[j++], a.beta0));
    const size_t n = a.n;
    a.out[t] = x.a;
    a.out[n + t] = x.b;
    a.out[2 * n + t] = x.c;
    a.out[3 * n + t] = x.d;
  }
}

template <int NF, bool kA, bool kB>
void launch(const Args& a, unsigned int blocks, cudaStream_t st) {
  fold_kernel<NF, kA, kB><<<blocks, kThreads, 0, st>>>(a);
}

}  // namespace

extern "C" int fri_fold_outputs_per_thread() { return kK; }

// src, inj_a, inj_b: (4, m) int32 arrays with rows `stride` words apart
// (inj_a and inj_b null where not injected); i1, ia, i2, ib: the twiddles
// of the chunk's pair 0 (null where not read); betas: beta, beta2, beta0 as
// 12 host words; out: (4, n). Returns the CUDA error (cudaErrorInvalidValue
// for a mode or arguments the kernel does not take, n past its 32-bit
// indices included).
extern "C" int fri_fold(int folds, const void* src, long long src_stride,
                        const void* inj_a, long long a_stride, const void* inj_b,
                        long long b_stride, const void* i1, const void* ia, const void* i2,
                        const void* ib, const unsigned int* betas, long long n, void* out,
                        void* stream) {
  const bool has_a = inj_a != nullptr, has_b = inj_b != nullptr;
  if (folds < 0 || folds > 2 || n < 1 || (n << (folds ? folds : 1)) > (1ll << 32) ||
      src == nullptr ||
      (has_a && (folds != 2 || ia == nullptr)) || (has_b && ib == nullptr) ||
      (folds && i1 == nullptr) || (folds == 2 && i2 == nullptr) || (!folds && !has_b)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.src = static_cast<const uint32_t*>(src);
  a.src_stride = src_stride;
  a.inj_a = static_cast<const uint32_t*>(inj_a);
  a.a_stride = a_stride;
  a.inj_b = static_cast<const uint32_t*>(inj_b);
  a.b_stride = b_stride;
  a.i1 = static_cast<const uint32_t*>(i1);
  a.ia = static_cast<const uint32_t*>(ia);
  a.i2 = static_cast<const uint32_t*>(i2);
  a.ib = static_cast<const uint32_t*>(ib);
  a.beta = {betas[0], betas[1], betas[2], betas[3]};
  a.beta2 = {betas[4], betas[5], betas[6], betas[7]};
  a.beta0 = {betas[8], betas[9], betas[10], betas[11]};
  a.n = static_cast<uint32_t>(n);
  a.stride = static_cast<uint32_t>((n + kK - 1) / kK);
  a.out = static_cast<uint32_t*>(out);
  const unsigned int blocks = (a.stride + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (folds == 0) {
    launch<0, false, true>(a, blocks, st);
  } else if (folds == 1) {
    has_b ? launch<1, false, true>(a, blocks, st)
          : launch<1, false, false>(a, blocks, st);
  } else if (has_a) {
    has_b ? launch<2, true, true>(a, blocks, st)
          : launch<2, true, false>(a, blocks, st);
  } else {
    has_b ? launch<2, false, true>(a, blocks, st)
          : launch<2, false, false>(a, blocks, st);
  }
  return static_cast<int>(cudaGetLastError());
}
