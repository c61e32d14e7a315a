// GENERATED by stwo_brainfuck_tpu_torch/ops/constraint_codegen.py from
// stwo_brainfuck_tpu_torch/components/defs.py; do not edit. Regenerate with
//
//     python -m stwo_brainfuck_tpu_torch.ops.constraint_codegen
//
// The constraint kernels of the 13 components for Hopper (sm_90a): the
// bodies below, one struct a component, plug into the hand-written
// skeletons csrc/constraint_kernel.cuh (composition: one launch a prove,
// a thread a row of one segment, every component of the segment summed in
// registers, the vanishing inverse, the stores; logup and interaction: the
// batched inversion between the denominators and the fractions) and
// csrc/logup_scan.cuh (interaction: the coset scan). Each body is the
// component's recorded constraint program (framework/component.py
// ConstraintProgram), one statement an op.

#include <cstdint>
#include <cuda_runtime.h>

#include "constraint_kernel.cuh"

namespace constraints {
namespace {

using qm31::Qm;

// memory (components/defs.py MemoryComponent): columns 8, LogUp relations 1, constraints 13
struct MemoryComponent {
  static constexpr int kColumns = 8;
  static constexpr int kRelations = 1;
  static constexpr int kConstraints = 13;
  static constexpr int kOwnWords = 80;

  // sum_i w_i * C_i at one row (w_i the component's weights)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(8);
    const Qm v1 = r.qcol(12);
    const Qm v2 = r.s_prev(16);
    const Qm v3 = r.own_qm(0);
    const uint32_t v4 = r.col(0);
    const uint32_t v5 = r.col(1);
    const uint32_t v6 = r.col(2);
    const uint32_t v7 = r.col(3);
    const uint32_t v8 = r.col(4);
    const uint32_t v9 = r.col(5);
    const uint32_t v10 = r.col(6);
    const uint32_t v11 = r.col(7);
    const uint32_t v12 = r.is_first();
    const uint32_t v13 = m31::mul(v12, v4);
    const uint32_t v14 = m31::mul(v12, v5);
    const uint32_t v15 = m31::mul(v12, v6);
    const uint32_t v16 = m31::mul(v12, v7);
    const uint32_t v17 = 1u;
    const uint32_t v18 = m31::sub(v7, v17);
    const uint32_t v19 = m31::mul(v7, v18);
    const uint32_t v20 = m31::sub(v11, v17);
    const uint32_t v21 = m31::mul(v11, v20);
    const uint32_t v22 = m31::sub(v9, v5);
    const uint32_t v23 = m31::sub(v22, v17);
    const uint32_t v24 = m31::mul(v22, v23);
    const uint32_t v25 = m31::sub(v8, v4);
    const uint32_t v26 = m31::sub(v25, v17);
    const uint32_t v27 = m31::mul(v23, v26);
    const uint32_t v28 = m31::mul(v22, v10);
    const uint32_t v29 = m31::mul(v7, v22);
    const uint32_t v30 = m31::sub(v10, v6);
    const uint32_t v31 = m31::mul(v7, v30);
    const Qm v32 = qm31::qm_combine<3>(r.consts, 0, {v4, v5, v6}, 12);
    const Qm v33 = qm31::qm_mul<CompositionProduct>(v0, v32);
    const Qm v34 = qm31::qm_sub(v33, qm31::qm_from_m31(v18));
    const Qm v35 = qm31::qm_sub(v1, v2);
    const Qm v36 = qm31::qm_sub(v35, v0);
    const Qm v37 = qm31::qm_mul_m31<CompositionProduct>(v3, v12);
    const Qm v38 = qm31::qm_add(v36, v37);
    uint32_t s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint64_t x = m31::mac(0, r.weight(0 + c), v13);
      x = m31::mac(x, r.weight(4 + c), v14);
      x = m31::mac(x, r.weight(8 + c), v15);
      x = m31::mac(x, r.weight(12 + c), v16);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(16 + c), v19);
      x = m31::mac(x, r.weight(20 + c), v21);
      x = m31::mac(x, r.weight(24 + c), v24);
      x = m31::mac(x, r.weight(28 + c), v27);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(32 + c), v28);
      x = m31::mac(x, r.weight(36 + c), v29);
      x = m31::mac(x, r.weight(40 + c), v31);
      x = m31::mac(x, r.weight(44 + 4 * c + 0), v34.a);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(44 + 4 * c + 1), v34.b);
      x = m31::mac(x, r.weight(44 + 4 * c + 2), v34.c);
      x = m31::mac(x, r.weight(44 + 4 * c + 3), v34.d);
      x = m31::mac(x, r.weight(60 + 4 * c + 0), v38.a);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(60 + 4 * c + 1), v38.b);
      x = m31::mac(x, r.weight(60 + 4 * c + 2), v38.c);
      x = m31::mac(x, r.weight(60 + 4 * c + 3), v38.d);
      s[c] = m31::reduce64(x);
    }
    return {s[0], s[1], s[2], s[3]};
  }

  // den_k of each relation at one row
  template <class R>
  __device__ __forceinline__ static void denominators(const R& r, Qm* den) {
    const uint32_t v4 = r.col(0);
    const uint32_t v5 = r.col(1);
    const uint32_t v6 = r.col(2);
    const Qm v32 = qm31::qm_combine<3>(r.consts, 0, {v4, v5, v6}, 12);
    den[0] = v32;
  }

  // Q_k = num_k * inv[k] of each relation at one row, inv[k] = den_k^-1
  template <class R>
  __device__ __forceinline__ static void fractions(const R& r, const Qm* inv, Qm* q) {
    const uint32_t v7 = r.col(3);
    const uint32_t v17 = 1u;
    const uint32_t v18 = m31::sub(v7, v17);
    const Qm v39 = inv[0];
    const Qm v40 = qm31::qm_mul_m31(v39, v18);
    q[0] = v40;
  }
};

// instruction (components/defs.py InstructionComponent): columns 8, LogUp relations 1, constraints 12
struct InstructionComponent {
  static constexpr int kColumns = 8;
  static constexpr int kRelations = 1;
  static constexpr int kConstraints = 12;
  static constexpr int kOwnWords = 76;

  // sum_i w_i * C_i at one row (w_i the component's weights)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(8);
    const Qm v1 = r.qcol(12);
    const Qm v2 = r.s_prev(16);
    const Qm v3 = r.own_qm(0);
    const uint32_t v4 = r.col(0);
    const uint32_t v5 = r.col(1);
    const uint32_t v6 = r.col(2);
    const uint32_t v7 = r.col(3);
    const uint32_t v8 = r.col(4);
    const uint32_t v9 = r.col(5);
    const uint32_t v10 = r.col(6);
    const uint32_t v11 = r.col(7);
    const uint32_t v12 = r.is_first();
    const uint32_t v13 = m31::mul(v12, v4);
    const uint32_t v14 = 1u;
    const uint32_t v15 = m31::sub(v7, v14);
    const uint32_t v16 = m31::mul(v7, v15);
    const uint32_t v17 = m31::sub(v11, v14);
    const uint32_t v18 = m31::mul(v11, v17);
    const uint32_t v19 = m31::mul(v7, v5);
    const uint32_t v20 = m31::mul(v7, v6);
    const uint32_t v21 = m31::mul(v11, v9);
    const uint32_t v22 = m31::mul(v11, v10);
    const uint32_t v23 = m31::sub(v8, v4);
    const uint32_t v24 = m31::sub(v23, v14);
    const uint32_t v25 = m31::mul(v23, v24);
    const uint32_t v26 = m31::sub(v9, v5);
    const uint32_t v27 = m31::mul(v24, v26);
    const uint32_t v28 = m31::sub(v10, v6);
    const uint32_t v29 = m31::mul(v24, v28);
    const Qm v30 = qm31::qm_combine<3>(r.consts, 16, {v4, v5, v6}, 28);
    const Qm v31 = qm31::qm_mul<CompositionProduct>(v0, v30);
    const Qm v32 = qm31::qm_sub(v31, qm31::qm_from_m31(v15));
    const Qm v33 = qm31::qm_sub(v1, v2);
    const Qm v34 = qm31::qm_sub(v33, v0);
    const Qm v35 = qm31::qm_mul_m31<CompositionProduct>(v3, v12);
    const Qm v36 = qm31::qm_add(v34, v35);
    uint32_t s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint64_t x = m31::mac(0, r.weight(0 + c), v13);
      x = m31::mac(x, r.weight(4 + c), v16);
      x = m31::mac(x, r.weight(8 + c), v18);
      x = m31::mac(x, r.weight(12 + c), v19);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(16 + c), v20);
      x = m31::mac(x, r.weight(20 + c), v21);
      x = m31::mac(x, r.weight(24 + c), v22);
      x = m31::mac(x, r.weight(28 + c), v25);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(32 + c), v27);
      x = m31::mac(x, r.weight(36 + c), v29);
      x = m31::mac(x, r.weight(40 + 4 * c + 0), v32.a);
      x = m31::mac(x, r.weight(40 + 4 * c + 1), v32.b);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(40 + 4 * c + 2), v32.c);
      x = m31::mac(x, r.weight(40 + 4 * c + 3), v32.d);
      x = m31::mac(x, r.weight(56 + 4 * c + 0), v36.a);
      x = m31::mac(x, r.weight(56 + 4 * c + 1), v36.b);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(56 + 4 * c + 2), v36.c);
      x = m31::mac(x, r.weight(56 + 4 * c + 3), v36.d);
      s[c] = m31::reduce64(x);
    }
    return {s[0], s[1], s[2], s[3]};
  }

  // den_k of each relation at one row
  template <class R>
  __device__ __forceinline__ static void denominators(const R& r, Qm* den) {
    const uint32_t v4 = r.col(0);
    const uint32_t v5 = r.col(1);
    const uint32_t v6 = r.col(2);
    const Qm v30 = qm31::qm_combine<3>(r.consts, 16, {v4, v5, v6}, 28);
    den[0] = v30;
  }

  // Q_k = num_k * inv[k] of each relation at one row, inv[k] = den_k^-1
  template <class R>
  __device__ __forceinline__ static void fractions(const R& r, const Qm* inv, Qm* q) {
    const uint32_t v7 = r.col(3);
    const uint32_t v14 = 1u;
    const uint32_t v15 = m31::sub(v7, v14);
    const Qm v37 = inv[0];
    const Qm v38 = qm31::qm_mul_m31(v37, v15);
    q[0] = v38;
  }
};

// program (components/defs.py ProgramComponent): columns 4, LogUp relations 1, constraints 6
struct ProgramComponent {
  static constexpr int kColumns = 4;
  static constexpr int kRelations = 1;
  static constexpr int kConstraints = 6;
  static constexpr int kOwnWords = 52;

  // sum_i w_i * C_i at one row (w_i the component's weights)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(4);
    const Qm v1 = r.qcol(8);
    const Qm v2 = r.s_prev(12);
    const Qm v3 = r.own_qm(0);
    const uint32_t v4 = r.col(0);
    const uint32_t v5 = r.col(1);
    const uint32_t v6 = r.col(2);
    const uint32_t v7 = r.col(3);
    const uint32_t v8 = r.is_first();
    const uint32_t v9 = m31::mul(v8, v4);
    const uint32_t v10 = 1u;
    const uint32_t v11 = m31::sub(v7, v10);
    const uint32_t v12 = m31::mul(v7, v11);
    const uint32_t v13 = m31::mul(v7, v5);
    const uint32_t v14 = m31::mul(v7, v6);
    const uint32_t v15 = m31::sub(v10, v7);
    const Qm v16 = qm31::qm_combine<3>(r.consts, 16, {v4, v5, v6}, 28);
    const Qm v17 = qm31::qm_mul<CompositionProduct>(v0, v16);
    const Qm v18 = qm31::qm_sub(v17, qm31::qm_from_m31(v15));
    const Qm v19 = qm31::qm_sub(v1, v2);
    const Qm v20 = qm31::qm_sub(v19, v0);
    const Qm v21 = qm31::qm_mul_m31<CompositionProduct>(v3, v8);
    const Qm v22 = qm31::qm_add(v20, v21);
    uint32_t s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint64_t x = m31::mac(0, r.weight(0 + c), v9);
      x = m31::mac(x, r.weight(4 + c), v12);
      x = m31::mac(x, r.weight(8 + c), v13);
      x = m31::mac(x, r.weight(12 + c), v14);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(16 + 4 * c + 0), v18.a);
      x = m31::mac(x, r.weight(16 + 4 * c + 1), v18.b);
      x = m31::mac(x, r.weight(16 + 4 * c + 2), v18.c);
      x = m31::mac(x, r.weight(16 + 4 * c + 3), v18.d);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(32 + 4 * c + 0), v22.a);
      x = m31::mac(x, r.weight(32 + 4 * c + 1), v22.b);
      x = m31::mac(x, r.weight(32 + 4 * c + 2), v22.c);
      x = m31::mac(x, r.weight(32 + 4 * c + 3), v22.d);
      s[c] = m31::reduce64(x);
    }
    return {s[0], s[1], s[2], s[3]};
  }

  // den_k of each relation at one row
  template <class R>
  __device__ __forceinline__ static void denominators(const R& r, Qm* den) {
    const uint32_t v4 = r.col(0);
    const uint32_t v5 = r.col(1);
    const uint32_t v6 = r.col(2);
    const Qm v16 = qm31::qm_combine<3>(r.consts, 16, {v4, v5, v6}, 28);
    den[0] = v16;
  }

  // Q_k = num_k * inv[k] of each relation at one row, inv[k] = den_k^-1
  template <class R>
  __device__ __forceinline__ static void fractions(const R& r, const Qm* inv, Qm* q) {
    const uint32_t v7 = r.col(3);
    const uint32_t v10 = 1u;
    const uint32_t v15 = m31::sub(v10, v7);
    const Qm v23 = inv[0];
    const Qm v24 = qm31::qm_mul_m31(v23, v15);
    q[0] = v24;
  }
};

// processor (components/defs.py ProcessorComponent): columns 9, LogUp relations 3, constraints 11
struct ProcessorComponent {
  static constexpr int kColumns = 9;
  static constexpr int kRelations = 3;
  static constexpr int kConstraints = 11;
  static constexpr int kOwnWords = 96;

  // sum_i w_i * C_i at one row (w_i the component's weights)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(9);
    const Qm v1 = r.qcol(13);
    const Qm v2 = r.qcol(17);
    const Qm v3 = r.qcol(21);
    const Qm v4 = r.s_prev(25);
    const Qm v5 = r.own_qm(0);
    const uint32_t v6 = r.col(0);
    const uint32_t v7 = r.col(1);
    const uint32_t v8 = r.col(2);
    const uint32_t v9 = r.col(3);
    const uint32_t v10 = r.col(4);
    const uint32_t v11 = r.col(5);
    const uint32_t v12 = r.col(6);
    const uint32_t v13 = r.col(7);
    const uint32_t v14 = r.col(8);
    const uint32_t v15 = r.is_first();
    const uint32_t v16 = m31::mul(v15, v6);
    const uint32_t v17 = m31::mul(v15, v7);
    const uint32_t v18 = m31::mul(v15, v10);
    const uint32_t v19 = m31::mul(v15, v11);
    const uint32_t v20 = m31::mul(v11, v12);
    const uint32_t v21 = 1u;
    const uint32_t v22 = m31::sub(v20, v21);
    const uint32_t v23 = m31::mul(v11, v22);
    const uint32_t v24 = m31::mul(v12, v22);
    const uint32_t v25 = m31::sub(v14, v6);
    const uint32_t v26 = m31::sub(v25, v21);
    const uint32_t v27 = m31::sub(v21, v13);
    const Qm v28 = qm31::qm_combine<7>(r.consts, 32, {v6, v7, v8, v9, v10, v11, v12}, 60);
    const Qm v29 = qm31::qm_mul<CompositionProduct>(v0, v28);
    const Qm v30 = qm31::qm_sub(v29, qm31::qm_from_m31(v27));
    const Qm v31 = qm31::qm_combine<3>(r.consts, 16, {v7, v8, v9}, 28);
    const Qm v32 = qm31::qm_mul<CompositionProduct>(v1, v31);
    const Qm v33 = qm31::qm_sub(v32, qm31::qm_from_m31(v27));
    const Qm v34 = qm31::qm_add(v0, v1);
    const Qm v35 = qm31::qm_combine<3>(r.consts, 0, {v6, v10, v11}, 12);
    const Qm v36 = qm31::qm_mul<CompositionProduct>(v2, v35);
    const Qm v37 = qm31::qm_sub(v36, qm31::qm_from_m31(v27));
    const Qm v38 = qm31::qm_add(v34, v2);
    const Qm v39 = qm31::qm_sub(v3, v4);
    const Qm v40 = qm31::qm_sub(v39, v38);
    const Qm v41 = qm31::qm_mul_m31<CompositionProduct>(v5, v15);
    const Qm v42 = qm31::qm_add(v40, v41);
    uint32_t s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint64_t x = m31::mac(0, r.weight(0 + c), v16);
      x = m31::mac(x, r.weight(4 + c), v17);
      x = m31::mac(x, r.weight(8 + c), v18);
      x = m31::mac(x, r.weight(12 + c), v19);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(16 + c), v23);
      x = m31::mac(x, r.weight(20 + c), v24);
      x = m31::mac(x, r.weight(24 + c), v26);
      x = m31::mac(x, r.weight(28 + 4 * c + 0), v30.a);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(28 + 4 * c + 1), v30.b);
      x = m31::mac(x, r.weight(28 + 4 * c + 2), v30.c);
      x = m31::mac(x, r.weight(28 + 4 * c + 3), v30.d);
      x = m31::mac(x, r.weight(44 + 4 * c + 0), v33.a);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(44 + 4 * c + 1), v33.b);
      x = m31::mac(x, r.weight(44 + 4 * c + 2), v33.c);
      x = m31::mac(x, r.weight(44 + 4 * c + 3), v33.d);
      x = m31::mac(x, r.weight(60 + 4 * c + 0), v37.a);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(60 + 4 * c + 1), v37.b);
      x = m31::mac(x, r.weight(60 + 4 * c + 2), v37.c);
      x = m31::mac(x, r.weight(60 + 4 * c + 3), v37.d);
      x = m31::mac(x, r.weight(76 + 4 * c + 0), v42.a);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(76 + 4 * c + 1), v42.b);
      x = m31::mac(x, r.weight(76 + 4 * c + 2), v42.c);
      x = m31::mac(x, r.weight(76 + 4 * c + 3), v42.d);
      s[c] = m31::reduce64(x);
    }
    return {s[0], s[1], s[2], s[3]};
  }

  // den_k of each relation at one row
  template <class R>
  __device__ __forceinline__ static void denominators(const R& r, Qm* den) {
    const uint32_t v6 = r.col(0);
    const uint32_t v7 = r.col(1);
    const uint32_t v8 = r.col(2);
    const uint32_t v9 = r.col(3);
    const uint32_t v10 = r.col(4);
    const uint32_t v11 = r.col(5);
    const uint32_t v12 = r.col(6);
    const Qm v28 = qm31::qm_combine<7>(r.consts, 32, {v6, v7, v8, v9, v10, v11, v12}, 60);
    const Qm v31 = qm31::qm_combine<3>(r.consts, 16, {v7, v8, v9}, 28);
    const Qm v35 = qm31::qm_combine<3>(r.consts, 0, {v6, v10, v11}, 12);
    den[0] = v28;
    den[1] = v31;
    den[2] = v35;
  }

  // Q_k = num_k * inv[k] of each relation at one row, inv[k] = den_k^-1
  template <class R>
  __device__ __forceinline__ static void fractions(const R& r, const Qm* inv, Qm* q) {
    const uint32_t v13 = r.col(7);
    const uint32_t v21 = 1u;
    const uint32_t v27 = m31::sub(v21, v13);
    const Qm v43 = inv[0];
    const Qm v44 = qm31::qm_mul_m31(v43, v27);
    const Qm v45 = inv[1];
    const Qm v46 = qm31::qm_mul_m31(v45, v27);
    const Qm v47 = inv[2];
    const Qm v48 = qm31::qm_mul_m31(v47, v27);
    q[0] = v44;
    q[1] = v46;
    q[2] = v48;
  }
};

// jump_if_not_zero (components/defs.py JumpIfNotZeroComponent): columns 13, LogUp relations 1, constraints 10
struct JumpIfNotZeroComponent {
  static constexpr int kColumns = 13;
  static constexpr int kRelations = 1;
  static constexpr int kConstraints = 10;
  static constexpr int kOwnWords = 68;

  // sum_i w_i * C_i at one row (w_i the component's weights)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(13);
    const Qm v1 = r.qcol(17);
    const Qm v2 = r.s_prev(21);
    const Qm v3 = r.own_qm(0);
    const uint32_t v4 = r.col(0);
    const uint32_t v5 = r.col(2);
    const uint32_t v6 = r.col(11);
    const uint32_t v7 = r.col(5);
    const uint32_t v8 = 93u;
    const uint32_t v9 = m31::sub(v5, v8);
    const uint32_t v10 = m31::mul(v5, v9);
    const uint32_t v11 = r.col(7);
    const uint32_t v12 = m31::sub(v11, v4);
    const uint32_t v13 = 1u;
    const uint32_t v14 = m31::sub(v12, v13);
    const uint32_t v15 = m31::sub(v6, v13);
    const uint32_t v16 = m31::mul(v6, v15);
    const uint32_t v17 = m31::mul(v6, v7);
    const uint32_t v18 = m31::mul(v6, v5);
    const uint32_t v19 = r.col(8);
    const uint32_t v20 = r.col(1);
    const uint32_t v21 = r.col(3);
    const uint32_t v22 = r.col(12);
    const uint32_t v23 = m31::sub(v19, v20);
    const uint32_t v24 = 2u;
    const uint32_t v25 = m31::sub(v23, v24);
    const uint32_t v26 = m31::mul(v22, v25);
    const uint32_t v27 = m31::sub(v19, v21);
    const uint32_t v28 = m31::mul(v7, v27);
    const uint32_t v29 = m31::add(v26, v28);
    const uint32_t v30 = m31::mul(v15, v29);
    const uint32_t v31 = r.col(9);
    const uint32_t v32 = r.col(4);
    const uint32_t v33 = m31::sub(v31, v32);
    const uint32_t v34 = r.col(10);
    const uint32_t v35 = m31::sub(v34, v7);
    const uint32_t v36 = r.col(6);
    const Qm v37 = qm31::qm_combine<7>(r.consts, 32, {v4, v20, v5, v21, v32, v7, v36}, 60);
    const Qm v38 = qm31::qm_mul<CompositionProduct>(v0, v37);
    const Qm v39 = qm31::qm_sub(v38, qm31::qm_from_m31(v15));
    const Qm v40 = qm31::qm_sub(v1, v2);
    const Qm v41 = qm31::qm_sub(v40, v0);
    const uint32_t v42 = r.is_first();
    const Qm v43 = qm31::qm_mul_m31<CompositionProduct>(v3, v42);
    const Qm v44 = qm31::qm_add(v41, v43);
    uint32_t s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint64_t x = m31::mac(0, r.weight(0 + c), v10);
      x = m31::mac(x, r.weight(4 + c), v14);
      x = m31::mac(x, r.weight(8 + c), v16);
      x = m31::mac(x, r.weight(12 + c), v17);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(16 + c), v18);
      x = m31::mac(x, r.weight(20 + c), v30);
      x = m31::mac(x, r.weight(24 + c), v33);
      x = m31::mac(x, r.weight(28 + c), v35);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(32 + 4 * c + 0), v39.a);
      x = m31::mac(x, r.weight(32 + 4 * c + 1), v39.b);
      x = m31::mac(x, r.weight(32 + 4 * c + 2), v39.c);
      x = m31::mac(x, r.weight(32 + 4 * c + 3), v39.d);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(48 + 4 * c + 0), v44.a);
      x = m31::mac(x, r.weight(48 + 4 * c + 1), v44.b);
      x = m31::mac(x, r.weight(48 + 4 * c + 2), v44.c);
      x = m31::mac(x, r.weight(48 + 4 * c + 3), v44.d);
      s[c] = m31::reduce64(x);
    }
    return {s[0], s[1], s[2], s[3]};
  }

  // den_k of each relation at one row
  template <class R>
  __device__ __forceinline__ static void denominators(const R& r, Qm* den) {
    const uint32_t v4 = r.col(0);
    const uint32_t v5 = r.col(2);
    const uint32_t v7 = r.col(5);
    const uint32_t v20 = r.col(1);
    const uint32_t v21 = r.col(3);
    const uint32_t v32 = r.col(4);
    const uint32_t v36 = r.col(6);
    const Qm v37 = qm31::qm_combine<7>(r.consts, 32, {v4, v20, v5, v21, v32, v7, v36}, 60);
    den[0] = v37;
  }

  // Q_k = num_k * inv[k] of each relation at one row, inv[k] = den_k^-1
  template <class R>
  __device__ __forceinline__ static void fractions(const R& r, const Qm* inv, Qm* q) {
    const uint32_t v6 = r.col(11);
    const uint32_t v13 = 1u;
    const uint32_t v15 = m31::sub(v6, v13);
    const Qm v45 = inv[0];
    const Qm v46 = qm31::qm_mul_m31(v45, v15);
    q[0] = v46;
  }
};

// jump_if_zero (components/defs.py JumpIfZeroComponent): columns 13, LogUp relations 1, constraints 10
struct JumpIfZeroComponent {
  static constexpr int kColumns = 13;
  static constexpr int kRelations = 1;
  static constexpr int kConstraints = 10;
  static constexpr int kOwnWords = 68;

  // sum_i w_i * C_i at one row (w_i the component's weights)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(13);
    const Qm v1 = r.qcol(17);
    const Qm v2 = r.s_prev(21);
    const Qm v3 = r.own_qm(0);
    const uint32_t v4 = r.col(0);
    const uint32_t v5 = r.col(2);
    const uint32_t v6 = r.col(11);
    const uint32_t v7 = r.col(5);
    const uint32_t v8 = 91u;
    const uint32_t v9 = m31::sub(v5, v8);
    const uint32_t v10 = m31::mul(v5, v9);
    const uint32_t v11 = r.col(7);
    const uint32_t v12 = m31::sub(v11, v4);
    const uint32_t v13 = 1u;
    const uint32_t v14 = m31::sub(v12, v13);
    const uint32_t v15 = m31::sub(v6, v13);
    const uint32_t v16 = m31::mul(v6, v15);
    const uint32_t v17 = m31::mul(v6, v7);
    const uint32_t v18 = m31::mul(v6, v5);
    const uint32_t v19 = r.col(8);
    const uint32_t v20 = r.col(1);
    const uint32_t v21 = r.col(3);
    const uint32_t v22 = r.col(12);
    const uint32_t v23 = m31::sub(v19, v20);
    const uint32_t v24 = 2u;
    const uint32_t v25 = m31::sub(v23, v24);
    const uint32_t v26 = m31::mul(v7, v25);
    const uint32_t v27 = m31::add(v21, v13);
    const uint32_t v28 = m31::sub(v19, v27);
    const uint32_t v29 = m31::mul(v22, v28);
    const uint32_t v30 = m31::add(v26, v29);
    const uint32_t v31 = m31::mul(v15, v30);
    const uint32_t v32 = r.col(9);
    const uint32_t v33 = r.col(4);
    const uint32_t v34 = m31::sub(v32, v33);
    const uint32_t v35 = r.col(10);
    const uint32_t v36 = m31::sub(v35, v7);
    const uint32_t v37 = r.col(6);
    const Qm v38 = qm31::qm_combine<7>(r.consts, 32, {v4, v20, v5, v21, v33, v7, v37}, 60);
    const Qm v39 = qm31::qm_mul<CompositionProduct>(v0, v38);
    const Qm v40 = qm31::qm_sub(v39, qm31::qm_from_m31(v15));
    const Qm v41 = qm31::qm_sub(v1, v2);
    const Qm v42 = qm31::qm_sub(v41, v0);
    const uint32_t v43 = r.is_first();
    const Qm v44 = qm31::qm_mul_m31<CompositionProduct>(v3, v43);
    const Qm v45 = qm31::qm_add(v42, v44);
    uint32_t s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint64_t x = m31::mac(0, r.weight(0 + c), v10);
      x = m31::mac(x, r.weight(4 + c), v14);
      x = m31::mac(x, r.weight(8 + c), v16);
      x = m31::mac(x, r.weight(12 + c), v17);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(16 + c), v18);
      x = m31::mac(x, r.weight(20 + c), v31);
      x = m31::mac(x, r.weight(24 + c), v34);
      x = m31::mac(x, r.weight(28 + c), v36);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(32 + 4 * c + 0), v40.a);
      x = m31::mac(x, r.weight(32 + 4 * c + 1), v40.b);
      x = m31::mac(x, r.weight(32 + 4 * c + 2), v40.c);
      x = m31::mac(x, r.weight(32 + 4 * c + 3), v40.d);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(48 + 4 * c + 0), v45.a);
      x = m31::mac(x, r.weight(48 + 4 * c + 1), v45.b);
      x = m31::mac(x, r.weight(48 + 4 * c + 2), v45.c);
      x = m31::mac(x, r.weight(48 + 4 * c + 3), v45.d);
      s[c] = m31::reduce64(x);
    }
    return {s[0], s[1], s[2], s[3]};
  }

  // den_k of each relation at one row
  template <class R>
  __device__ __forceinline__ static void denominators(const R& r, Qm* den) {
    const uint32_t v4 = r.col(0);
    const uint32_t v5 = r.col(2);
    const uint32_t v7 = r.col(5);
    const uint32_t v20 = r.col(1);
    const uint32_t v21 = r.col(3);
    const uint32_t v33 = r.col(4);
    const uint32_t v37 = r.col(6);
    const Qm v38 = qm31::qm_combine<7>(r.consts, 32, {v4, v20, v5, v21, v33, v7, v37}, 60);
    den[0] = v38;
  }

  // Q_k = num_k * inv[k] of each relation at one row, inv[k] = den_k^-1
  template <class R>
  __device__ __forceinline__ static void fractions(const R& r, const Qm* inv, Qm* q) {
    const uint32_t v6 = r.col(11);
    const uint32_t v13 = 1u;
    const uint32_t v15 = m31::sub(v6, v13);
    const Qm v46 = inv[0];
    const Qm v47 = qm31::qm_mul_m31(v46, v15);
    q[0] = v47;
  }
};

// input_instruction (components/defs.py InputComponent): columns 11, LogUp relations 1, constraints 8
struct InputComponent {
  static constexpr int kColumns = 11;
  static constexpr int kRelations = 1;
  static constexpr int kConstraints = 8;
  static constexpr int kOwnWords = 60;

  // sum_i w_i * C_i at one row (w_i the component's weights)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(11);
    const Qm v1 = r.qcol(15);
    const Qm v2 = r.s_prev(19);
    const Qm v3 = r.own_qm(0);
    const uint32_t v4 = r.col(2);
    const uint32_t v5 = r.col(7);
    const uint32_t v6 = r.col(5);
    const uint32_t v7 = r.col(1);
    const uint32_t v8 = r.col(8);
    const uint32_t v9 = 44u;
    const uint32_t v10 = m31::sub(v4, v9);
    const uint32_t v11 = m31::mul(v4, v10);
    const uint32_t v12 = 1u;
    const uint32_t v13 = m31::sub(v5, v12);
    const uint32_t v14 = m31::mul(v5, v13);
    const uint32_t v15 = m31::mul(v5, v6);
    const uint32_t v16 = m31::mul(v5, v4);
    const uint32_t v17 = m31::sub(v12, v5);
    const uint32_t v18 = m31::sub(v8, v7);
    const uint32_t v19 = m31::sub(v18, v12);
    const uint32_t v20 = m31::mul(v17, v19);
    const uint32_t v21 = r.col(9);
    const uint32_t v22 = r.col(4);
    const uint32_t v23 = m31::sub(v21, v22);
    const uint32_t v24 = r.col(0);
    const uint32_t v25 = r.col(3);
    const uint32_t v26 = r.col(6);
    const Qm v27 = qm31::qm_combine<7>(r.consts, 32, {v24, v7, v4, v25, v22, v6, v26}, 60);
    const Qm v28 = qm31::qm_mul<CompositionProduct>(v0, v27);
    const Qm v29 = qm31::qm_sub(v28, qm31::qm_from_m31(v13));
    const Qm v30 = qm31::qm_sub(v1, v2);
    const Qm v31 = qm31::qm_sub(v30, v0);
    const uint32_t v32 = r.is_first();
    const Qm v33 = qm31::qm_mul_m31<CompositionProduct>(v3, v32);
    const Qm v34 = qm31::qm_add(v31, v33);
    uint32_t s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint64_t x = m31::mac(0, r.weight(0 + c), v11);
      x = m31::mac(x, r.weight(4 + c), v14);
      x = m31::mac(x, r.weight(8 + c), v15);
      x = m31::mac(x, r.weight(12 + c), v16);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(16 + c), v20);
      x = m31::mac(x, r.weight(20 + c), v23);
      x = m31::mac(x, r.weight(24 + 4 * c + 0), v29.a);
      x = m31::mac(x, r.weight(24 + 4 * c + 1), v29.b);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(24 + 4 * c + 2), v29.c);
      x = m31::mac(x, r.weight(24 + 4 * c + 3), v29.d);
      x = m31::mac(x, r.weight(40 + 4 * c + 0), v34.a);
      x = m31::mac(x, r.weight(40 + 4 * c + 1), v34.b);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(40 + 4 * c + 2), v34.c);
      x = m31::mac(x, r.weight(40 + 4 * c + 3), v34.d);
      s[c] = m31::reduce64(x);
    }
    return {s[0], s[1], s[2], s[3]};
  }

  // den_k of each relation at one row
  template <class R>
  __device__ __forceinline__ static void denominators(const R& r, Qm* den) {
    const uint32_t v4 = r.col(2);
    const uint32_t v6 = r.col(5);
    const uint32_t v7 = r.col(1);
    const uint32_t v22 = r.col(4);
    const uint32_t v24 = r.col(0);
    const uint32_t v25 = r.col(3);
    const uint32_t v26 = r.col(6);
    const Qm v27 = qm31::qm_combine<7>(r.consts, 32, {v24, v7, v4, v25, v22, v6, v26}, 60);
    den[0] = v27;
  }

  // Q_k = num_k * inv[k] of each relation at one row, inv[k] = den_k^-1
  template <class R>
  __device__ __forceinline__ static void fractions(const R& r, const Qm* inv, Qm* q) {
    const uint32_t v5 = r.col(7);
    const uint32_t v12 = 1u;
    const uint32_t v13 = m31::sub(v5, v12);
    const Qm v35 = inv[0];
    const Qm v36 = qm31::qm_mul_m31(v35, v13);
    q[0] = v36;
  }
};

// left_instruction (components/defs.py LeftComponent): columns 11, LogUp relations 1, constraints 8
struct LeftComponent {
  static constexpr int kColumns = 11;
  static constexpr int kRelations = 1;
  static constexpr int kConstraints = 8;
  static constexpr int kOwnWords = 60;

  // sum_i w_i * C_i at one row (w_i the component's weights)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(11);
    const Qm v1 = r.qcol(15);
    const Qm v2 = r.s_prev(19);
    const Qm v3 = r.own_qm(0);
    const uint32_t v4 = r.col(2);
    const uint32_t v5 = r.col(7);
    const uint32_t v6 = r.col(5);
    const uint32_t v7 = r.col(1);
    const uint32_t v8 = r.col(8);
    const uint32_t v9 = 60u;
    const uint32_t v10 = m31::sub(v4, v9);
    const uint32_t v11 = m31::mul(v4, v10);
    const uint32_t v12 = 1u;
    const uint32_t v13 = m31::sub(v5, v12);
    const uint32_t v14 = m31::mul(v5, v13);
    const uint32_t v15 = m31::mul(v5, v6);
    const uint32_t v16 = m31::mul(v5, v4);
    const uint32_t v17 = m31::sub(v12, v5);
    const uint32_t v18 = m31::sub(v8, v7);
    const uint32_t v19 = m31::sub(v18, v12);
    const uint32_t v20 = m31::mul(v17, v19);
    const uint32_t v21 = r.col(9);
    const uint32_t v22 = r.col(4);
    const uint32_t v23 = m31::sub(v21, v22);
    const uint32_t v24 = m31::add(v23, v12);
    const uint32_t v25 = m31::mul(v17, v24);
    const uint32_t v26 = r.col(0);
    const uint32_t v27 = r.col(3);
    const uint32_t v28 = r.col(6);
    const Qm v29 = qm31::qm_combine<7>(r.consts, 32, {v26, v7, v4, v27, v22, v6, v28}, 60);
    const Qm v30 = qm31::qm_mul<CompositionProduct>(v0, v29);
    const Qm v31 = qm31::qm_sub(v30, qm31::qm_from_m31(v13));
    const Qm v32 = qm31::qm_sub(v1, v2);
    const Qm v33 = qm31::qm_sub(v32, v0);
    const uint32_t v34 = r.is_first();
    const Qm v35 = qm31::qm_mul_m31<CompositionProduct>(v3, v34);
    const Qm v36 = qm31::qm_add(v33, v35);
    uint32_t s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint64_t x = m31::mac(0, r.weight(0 + c), v11);
      x = m31::mac(x, r.weight(4 + c), v14);
      x = m31::mac(x, r.weight(8 + c), v15);
      x = m31::mac(x, r.weight(12 + c), v16);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(16 + c), v20);
      x = m31::mac(x, r.weight(20 + c), v25);
      x = m31::mac(x, r.weight(24 + 4 * c + 0), v31.a);
      x = m31::mac(x, r.weight(24 + 4 * c + 1), v31.b);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(24 + 4 * c + 2), v31.c);
      x = m31::mac(x, r.weight(24 + 4 * c + 3), v31.d);
      x = m31::mac(x, r.weight(40 + 4 * c + 0), v36.a);
      x = m31::mac(x, r.weight(40 + 4 * c + 1), v36.b);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(40 + 4 * c + 2), v36.c);
      x = m31::mac(x, r.weight(40 + 4 * c + 3), v36.d);
      s[c] = m31::reduce64(x);
    }
    return {s[0], s[1], s[2], s[3]};
  }

  // den_k of each relation at one row
  template <class R>
  __device__ __forceinline__ static void denominators(const R& r, Qm* den) {
    const uint32_t v4 = r.col(2);
    const uint32_t v6 = r.col(5);
    const uint32_t v7 = r.col(1);
    const uint32_t v22 = r.col(4);
    const uint32_t v26 = r.col(0);
    const uint32_t v27 = r.col(3);
    const uint32_t v28 = r.col(6);
    const Qm v29 = qm31::qm_combine<7>(r.consts, 32, {v26, v7, v4, v27, v22, v6, v28}, 60);
    den[0] = v29;
  }

  // Q_k = num_k * inv[k] of each relation at one row, inv[k] = den_k^-1
  template <class R>
  __device__ __forceinline__ static void fractions(const R& r, const Qm* inv, Qm* q) {
    const uint32_t v5 = r.col(7);
    const uint32_t v12 = 1u;
    const uint32_t v13 = m31::sub(v5, v12);
    const Qm v37 = inv[0];
    const Qm v38 = qm31::qm_mul_m31(v37, v13);
    q[0] = v38;
  }
};

// minus_instruction (components/defs.py MinusComponent): columns 11, LogUp relations 1, constraints 9
struct MinusComponent {
  static constexpr int kColumns = 11;
  static constexpr int kRelations = 1;
  static constexpr int kConstraints = 9;
  static constexpr int kOwnWords = 64;

  // sum_i w_i * C_i at one row (w_i the component's weights)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(11);
    const Qm v1 = r.qcol(15);
    const Qm v2 = r.s_prev(19);
    const Qm v3 = r.own_qm(0);
    const uint32_t v4 = r.col(2);
    const uint32_t v5 = r.col(7);
    const uint32_t v6 = r.col(5);
    const uint32_t v7 = r.col(1);
    const uint32_t v8 = r.col(8);
    const uint32_t v9 = 45u;
    const uint32_t v10 = m31::sub(v4, v9);
    const uint32_t v11 = m31::mul(v4, v10);
    const uint32_t v12 = 1u;
    const uint32_t v13 = m31::sub(v5, v12);
    const uint32_t v14 = m31::mul(v5, v13);
    const uint32_t v15 = m31::mul(v5, v6);
    const uint32_t v16 = m31::mul(v5, v4);
    const uint32_t v17 = m31::sub(v12, v5);
    const uint32_t v18 = m31::sub(v8, v7);
    const uint32_t v19 = m31::sub(v18, v12);
    const uint32_t v20 = m31::mul(v17, v19);
    const uint32_t v21 = r.col(9);
    const uint32_t v22 = r.col(4);
    const uint32_t v23 = m31::sub(v21, v22);
    const uint32_t v24 = r.col(10);
    const uint32_t v25 = m31::sub(v24, v6);
    const uint32_t v26 = m31::add(v25, v12);
    const uint32_t v27 = m31::mul(v17, v26);
    const uint32_t v28 = r.col(0);
    const uint32_t v29 = r.col(3);
    const uint32_t v30 = r.col(6);
    const Qm v31 = qm31::qm_combine<7>(r.consts, 32, {v28, v7, v4, v29, v22, v6, v30}, 60);
    const Qm v32 = qm31::qm_mul<CompositionProduct>(v0, v31);
    const Qm v33 = qm31::qm_sub(v32, qm31::qm_from_m31(v13));
    const Qm v34 = qm31::qm_sub(v1, v2);
    const Qm v35 = qm31::qm_sub(v34, v0);
    const uint32_t v36 = r.is_first();
    const Qm v37 = qm31::qm_mul_m31<CompositionProduct>(v3, v36);
    const Qm v38 = qm31::qm_add(v35, v37);
    uint32_t s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint64_t x = m31::mac(0, r.weight(0 + c), v11);
      x = m31::mac(x, r.weight(4 + c), v14);
      x = m31::mac(x, r.weight(8 + c), v15);
      x = m31::mac(x, r.weight(12 + c), v16);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(16 + c), v20);
      x = m31::mac(x, r.weight(20 + c), v23);
      x = m31::mac(x, r.weight(24 + c), v27);
      x = m31::mac(x, r.weight(28 + 4 * c + 0), v33.a);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(28 + 4 * c + 1), v33.b);
      x = m31::mac(x, r.weight(28 + 4 * c + 2), v33.c);
      x = m31::mac(x, r.weight(28 + 4 * c + 3), v33.d);
      x = m31::mac(x, r.weight(44 + 4 * c + 0), v38.a);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(44 + 4 * c + 1), v38.b);
      x = m31::mac(x, r.weight(44 + 4 * c + 2), v38.c);
      x = m31::mac(x, r.weight(44 + 4 * c + 3), v38.d);
      s[c] = m31::reduce64(x);
    }
    return {s[0], s[1], s[2], s[3]};
  }

  // den_k of each relation at one row
  template <class R>
  __device__ __forceinline__ static void denominators(const R& r, Qm* den) {
    const uint32_t v4 = r.col(2);
    const uint32_t v6 = r.col(5);
    const uint32_t v7 = r.col(1);
    const uint32_t v22 = r.col(4);
    const uint32_t v28 = r.col(0);
    const uint32_t v29 = r.col(3);
    const uint32_t v30 = r.col(6);
    const Qm v31 = qm31::qm_combine<7>(r.consts, 32, {v28, v7, v4, v29, v22, v6, v30}, 60);
    den[0] = v31;
  }

  // Q_k = num_k * inv[k] of each relation at one row, inv[k] = den_k^-1
  template <class R>
  __device__ __forceinline__ static void fractions(const R& r, const Qm* inv, Qm* q) {
    const uint32_t v5 = r.col(7);
    const uint32_t v12 = 1u;
    const uint32_t v13 = m31::sub(v5, v12);
    const Qm v39 = inv[0];
    const Qm v40 = qm31::qm_mul_m31(v39, v13);
    q[0] = v40;
  }
};

// output_instruction (components/defs.py OutputComponent): columns 11, LogUp relations 1, constraints 9
struct OutputComponent {
  static constexpr int kColumns = 11;
  static constexpr int kRelations = 1;
  static constexpr int kConstraints = 9;
  static constexpr int kOwnWords = 64;

  // sum_i w_i * C_i at one row (w_i the component's weights)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(11);
    const Qm v1 = r.qcol(15);
    const Qm v2 = r.s_prev(19);
    const Qm v3 = r.own_qm(0);
    const uint32_t v4 = r.col(2);
    const uint32_t v5 = r.col(7);
    const uint32_t v6 = r.col(5);
    const uint32_t v7 = r.col(1);
    const uint32_t v8 = r.col(8);
    const uint32_t v9 = 46u;
    const uint32_t v10 = m31::sub(v4, v9);
    const uint32_t v11 = m31::mul(v4, v10);
    const uint32_t v12 = 1u;
    const uint32_t v13 = m31::sub(v5, v12);
    const uint32_t v14 = m31::mul(v5, v13);
    const uint32_t v15 = m31::mul(v5, v6);
    const uint32_t v16 = m31::mul(v5, v4);
    const uint32_t v17 = m31::sub(v12, v5);
    const uint32_t v18 = m31::sub(v8, v7);
    const uint32_t v19 = m31::sub(v18, v12);
    const uint32_t v20 = m31::mul(v17, v19);
    const uint32_t v21 = r.col(9);
    const uint32_t v22 = r.col(4);
    const uint32_t v23 = m31::sub(v21, v22);
    const uint32_t v24 = r.col(10);
    const uint32_t v25 = m31::sub(v24, v6);
    const uint32_t v26 = r.col(0);
    const uint32_t v27 = r.col(3);
    const uint32_t v28 = r.col(6);
    const Qm v29 = qm31::qm_combine<7>(r.consts, 32, {v26, v7, v4, v27, v22, v6, v28}, 60);
    const Qm v30 = qm31::qm_mul<CompositionProduct>(v0, v29);
    const Qm v31 = qm31::qm_sub(v30, qm31::qm_from_m31(v13));
    const Qm v32 = qm31::qm_sub(v1, v2);
    const Qm v33 = qm31::qm_sub(v32, v0);
    const uint32_t v34 = r.is_first();
    const Qm v35 = qm31::qm_mul_m31<CompositionProduct>(v3, v34);
    const Qm v36 = qm31::qm_add(v33, v35);
    uint32_t s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint64_t x = m31::mac(0, r.weight(0 + c), v11);
      x = m31::mac(x, r.weight(4 + c), v14);
      x = m31::mac(x, r.weight(8 + c), v15);
      x = m31::mac(x, r.weight(12 + c), v16);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(16 + c), v20);
      x = m31::mac(x, r.weight(20 + c), v23);
      x = m31::mac(x, r.weight(24 + c), v25);
      x = m31::mac(x, r.weight(28 + 4 * c + 0), v31.a);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(28 + 4 * c + 1), v31.b);
      x = m31::mac(x, r.weight(28 + 4 * c + 2), v31.c);
      x = m31::mac(x, r.weight(28 + 4 * c + 3), v31.d);
      x = m31::mac(x, r.weight(44 + 4 * c + 0), v36.a);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(44 + 4 * c + 1), v36.b);
      x = m31::mac(x, r.weight(44 + 4 * c + 2), v36.c);
      x = m31::mac(x, r.weight(44 + 4 * c + 3), v36.d);
      s[c] = m31::reduce64(x);
    }
    return {s[0], s[1], s[2], s[3]};
  }

  // den_k of each relation at one row
  template <class R>
  __device__ __forceinline__ static void denominators(const R& r, Qm* den) {
    const uint32_t v4 = r.col(2);
    const uint32_t v6 = r.col(5);
    const uint32_t v7 = r.col(1);
    const uint32_t v22 = r.col(4);
    const uint32_t v26 = r.col(0);
    const uint32_t v27 = r.col(3);
    const uint32_t v28 = r.col(6);
    const Qm v29 = qm31::qm_combine<7>(r.consts, 32, {v26, v7, v4, v27, v22, v6, v28}, 60);
    den[0] = v29;
  }

  // Q_k = num_k * inv[k] of each relation at one row, inv[k] = den_k^-1
  template <class R>
  __device__ __forceinline__ static void fractions(const R& r, const Qm* inv, Qm* q) {
    const uint32_t v5 = r.col(7);
    const uint32_t v12 = 1u;
    const uint32_t v13 = m31::sub(v5, v12);
    const Qm v37 = inv[0];
    const Qm v38 = qm31::qm_mul_m31(v37, v13);
    q[0] = v38;
  }
};

// plus_instruction (components/defs.py PlusComponent): columns 11, LogUp relations 1, constraints 9
struct PlusComponent {
  static constexpr int kColumns = 11;
  static constexpr int kRelations = 1;
  static constexpr int kConstraints = 9;
  static constexpr int kOwnWords = 64;

  // sum_i w_i * C_i at one row (w_i the component's weights)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(11);
    const Qm v1 = r.qcol(15);
    const Qm v2 = r.s_prev(19);
    const Qm v3 = r.own_qm(0);
    const uint32_t v4 = r.col(2);
    const uint32_t v5 = r.col(7);
    const uint32_t v6 = r.col(5);
    const uint32_t v7 = r.col(1);
    const uint32_t v8 = r.col(8);
    const uint32_t v9 = 43u;
    const uint32_t v10 = m31::sub(v4, v9);
    const uint32_t v11 = m31::mul(v4, v10);
    const uint32_t v12 = 1u;
    const uint32_t v13 = m31::sub(v5, v12);
    const uint32_t v14 = m31::mul(v5, v13);
    const uint32_t v15 = m31::mul(v5, v6);
    const uint32_t v16 = m31::mul(v5, v4);
    const uint32_t v17 = m31::sub(v12, v5);
    const uint32_t v18 = m31::sub(v8, v7);
    const uint32_t v19 = m31::sub(v18, v12);
    const uint32_t v20 = m31::mul(v17, v19);
    const uint32_t v21 = r.col(9);
    const uint32_t v22 = r.col(4);
    const uint32_t v23 = m31::sub(v21, v22);
    const uint32_t v24 = r.col(10);
    const uint32_t v25 = m31::sub(v24, v6);
    const uint32_t v26 = m31::sub(v25, v12);
    const uint32_t v27 = m31::mul(v17, v26);
    const uint32_t v28 = r.col(0);
    const uint32_t v29 = r.col(3);
    const uint32_t v30 = r.col(6);
    const Qm v31 = qm31::qm_combine<7>(r.consts, 32, {v28, v7, v4, v29, v22, v6, v30}, 60);
    const Qm v32 = qm31::qm_mul<CompositionProduct>(v0, v31);
    const Qm v33 = qm31::qm_sub(v32, qm31::qm_from_m31(v13));
    const Qm v34 = qm31::qm_sub(v1, v2);
    const Qm v35 = qm31::qm_sub(v34, v0);
    const uint32_t v36 = r.is_first();
    const Qm v37 = qm31::qm_mul_m31<CompositionProduct>(v3, v36);
    const Qm v38 = qm31::qm_add(v35, v37);
    uint32_t s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint64_t x = m31::mac(0, r.weight(0 + c), v11);
      x = m31::mac(x, r.weight(4 + c), v14);
      x = m31::mac(x, r.weight(8 + c), v15);
      x = m31::mac(x, r.weight(12 + c), v16);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(16 + c), v20);
      x = m31::mac(x, r.weight(20 + c), v23);
      x = m31::mac(x, r.weight(24 + c), v27);
      x = m31::mac(x, r.weight(28 + 4 * c + 0), v33.a);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(28 + 4 * c + 1), v33.b);
      x = m31::mac(x, r.weight(28 + 4 * c + 2), v33.c);
      x = m31::mac(x, r.weight(28 + 4 * c + 3), v33.d);
      x = m31::mac(x, r.weight(44 + 4 * c + 0), v38.a);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(44 + 4 * c + 1), v38.b);
      x = m31::mac(x, r.weight(44 + 4 * c + 2), v38.c);
      x = m31::mac(x, r.weight(44 + 4 * c + 3), v38.d);
      s[c] = m31::reduce64(x);
    }
    return {s[0], s[1], s[2], s[3]};
  }

  // den_k of each relation at one row
  template <class R>
  __device__ __forceinline__ static void denominators(const R& r, Qm* den) {
    const uint32_t v4 = r.col(2);
    const uint32_t v6 = r.col(5);
    const uint32_t v7 = r.col(1);
    const uint32_t v22 = r.col(4);
    const uint32_t v28 = r.col(0);
    const uint32_t v29 = r.col(3);
    const uint32_t v30 = r.col(6);
    const Qm v31 = qm31::qm_combine<7>(r.consts, 32, {v28, v7, v4, v29, v22, v6, v30}, 60);
    den[0] = v31;
  }

  // Q_k = num_k * inv[k] of each relation at one row, inv[k] = den_k^-1
  template <class R>
  __device__ __forceinline__ static void fractions(const R& r, const Qm* inv, Qm* q) {
    const uint32_t v5 = r.col(7);
    const uint32_t v12 = 1u;
    const uint32_t v13 = m31::sub(v5, v12);
    const Qm v39 = inv[0];
    const Qm v40 = qm31::qm_mul_m31(v39, v13);
    q[0] = v40;
  }
};

// right_instruction (components/defs.py RightComponent): columns 11, LogUp relations 1, constraints 8
struct RightComponent {
  static constexpr int kColumns = 11;
  static constexpr int kRelations = 1;
  static constexpr int kConstraints = 8;
  static constexpr int kOwnWords = 60;

  // sum_i w_i * C_i at one row (w_i the component's weights)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(11);
    const Qm v1 = r.qcol(15);
    const Qm v2 = r.s_prev(19);
    const Qm v3 = r.own_qm(0);
    const uint32_t v4 = r.col(2);
    const uint32_t v5 = r.col(7);
    const uint32_t v6 = r.col(5);
    const uint32_t v7 = r.col(1);
    const uint32_t v8 = r.col(8);
    const uint32_t v9 = 62u;
    const uint32_t v10 = m31::sub(v4, v9);
    const uint32_t v11 = m31::mul(v4, v10);
    const uint32_t v12 = 1u;
    const uint32_t v13 = m31::sub(v5, v12);
    const uint32_t v14 = m31::mul(v5, v13);
    const uint32_t v15 = m31::mul(v5, v6);
    const uint32_t v16 = m31::mul(v5, v4);
    const uint32_t v17 = m31::sub(v12, v5);
    const uint32_t v18 = m31::sub(v8, v7);
    const uint32_t v19 = m31::sub(v18, v12);
    const uint32_t v20 = m31::mul(v17, v19);
    const uint32_t v21 = r.col(9);
    const uint32_t v22 = r.col(4);
    const uint32_t v23 = m31::sub(v21, v22);
    const uint32_t v24 = m31::sub(v23, v12);
    const uint32_t v25 = m31::mul(v17, v24);
    const uint32_t v26 = r.col(0);
    const uint32_t v27 = r.col(3);
    const uint32_t v28 = r.col(6);
    const Qm v29 = qm31::qm_combine<7>(r.consts, 32, {v26, v7, v4, v27, v22, v6, v28}, 60);
    const Qm v30 = qm31::qm_mul<CompositionProduct>(v0, v29);
    const Qm v31 = qm31::qm_sub(v30, qm31::qm_from_m31(v13));
    const Qm v32 = qm31::qm_sub(v1, v2);
    const Qm v33 = qm31::qm_sub(v32, v0);
    const uint32_t v34 = r.is_first();
    const Qm v35 = qm31::qm_mul_m31<CompositionProduct>(v3, v34);
    const Qm v36 = qm31::qm_add(v33, v35);
    uint32_t s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint64_t x = m31::mac(0, r.weight(0 + c), v11);
      x = m31::mac(x, r.weight(4 + c), v14);
      x = m31::mac(x, r.weight(8 + c), v15);
      x = m31::mac(x, r.weight(12 + c), v16);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(16 + c), v20);
      x = m31::mac(x, r.weight(20 + c), v25);
      x = m31::mac(x, r.weight(24 + 4 * c + 0), v31.a);
      x = m31::mac(x, r.weight(24 + 4 * c + 1), v31.b);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(24 + 4 * c + 2), v31.c);
      x = m31::mac(x, r.weight(24 + 4 * c + 3), v31.d);
      x = m31::mac(x, r.weight(40 + 4 * c + 0), v36.a);
      x = m31::mac(x, r.weight(40 + 4 * c + 1), v36.b);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(40 + 4 * c + 2), v36.c);
      x = m31::mac(x, r.weight(40 + 4 * c + 3), v36.d);
      s[c] = m31::reduce64(x);
    }
    return {s[0], s[1], s[2], s[3]};
  }

  // den_k of each relation at one row
  template <class R>
  __device__ __forceinline__ static void denominators(const R& r, Qm* den) {
    const uint32_t v4 = r.col(2);
    const uint32_t v6 = r.col(5);
    const uint32_t v7 = r.col(1);
    const uint32_t v22 = r.col(4);
    const uint32_t v26 = r.col(0);
    const uint32_t v27 = r.col(3);
    const uint32_t v28 = r.col(6);
    const Qm v29 = qm31::qm_combine<7>(r.consts, 32, {v26, v7, v4, v27, v22, v6, v28}, 60);
    den[0] = v29;
  }

  // Q_k = num_k * inv[k] of each relation at one row, inv[k] = den_k^-1
  template <class R>
  __device__ __forceinline__ static void fractions(const R& r, const Qm* inv, Qm* q) {
    const uint32_t v5 = r.col(7);
    const uint32_t v12 = 1u;
    const uint32_t v13 = m31::sub(v5, v12);
    const Qm v37 = inv[0];
    const Qm v38 = qm31::qm_mul_m31(v37, v13);
    q[0] = v38;
  }
};

// end_of_execution (components/defs.py EndOfExecutionComponent): columns 7, LogUp relations 1, constraints 3
struct EndOfExecutionComponent {
  static constexpr int kColumns = 7;
  static constexpr int kRelations = 1;
  static constexpr int kConstraints = 3;
  static constexpr int kOwnWords = 40;

  // sum_i w_i * C_i at one row (w_i the component's weights)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(7);
    const Qm v1 = r.qcol(11);
    const Qm v2 = r.s_prev(15);
    const Qm v3 = r.own_qm(0);
    const uint32_t v4 = r.col(2);
    const uint32_t v5 = r.is_first();
    const uint32_t v6 = 0u;
    const uint32_t v7 = m31::sub(v6, v5);
    const uint32_t v8 = r.col(0);
    const uint32_t v9 = r.col(1);
    const uint32_t v10 = r.col(3);
    const uint32_t v11 = r.col(4);
    const uint32_t v12 = r.col(5);
    const uint32_t v13 = r.col(6);
    const Qm v14 = qm31::qm_combine<7>(r.consts, 32, {v8, v9, v4, v10, v11, v12, v13}, 60);
    const Qm v15 = qm31::qm_mul<CompositionProduct>(v0, v14);
    const Qm v16 = qm31::qm_sub(v15, qm31::qm_from_m31(v7));
    const Qm v17 = qm31::qm_sub(v1, v2);
    const Qm v18 = qm31::qm_sub(v17, v0);
    const Qm v19 = qm31::qm_mul_m31<CompositionProduct>(v3, v5);
    const Qm v20 = qm31::qm_add(v18, v19);
    uint32_t s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint64_t x = m31::mac(0, r.weight(0 + c), v4);
      x = m31::mac(x, r.weight(4 + 4 * c + 0), v16.a);
      x = m31::mac(x, r.weight(4 + 4 * c + 1), v16.b);
      x = m31::mac(x, r.weight(4 + 4 * c + 2), v16.c);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(4 + 4 * c + 3), v16.d);
      x = m31::mac(x, r.weight(20 + 4 * c + 0), v20.a);
      x = m31::mac(x, r.weight(20 + 4 * c + 1), v20.b);
      x = m31::mac(x, r.weight(20 + 4 * c + 2), v20.c);
      x = m31::fold64(x);
      x = m31::mac(x, r.weight(20 + 4 * c + 3), v20.d);
      s[c] = m31::reduce64(x);
    }
    return {s[0], s[1], s[2], s[3]};
  }

  // den_k of each relation at one row
  template <class R>
  __device__ __forceinline__ static void denominators(const R& r, Qm* den) {
    const uint32_t v4 = r.col(2);
    const uint32_t v8 = r.col(0);
    const uint32_t v9 = r.col(1);
    const uint32_t v10 = r.col(3);
    const uint32_t v11 = r.col(4);
    const uint32_t v12 = r.col(5);
    const uint32_t v13 = r.col(6);
    const Qm v14 = qm31::qm_combine<7>(r.consts, 32, {v8, v9, v4, v10, v11, v12, v13}, 60);
    den[0] = v14;
  }

  // Q_k = num_k * inv[k] of each relation at one row, inv[k] = den_k^-1
  template <class R>
  __device__ __forceinline__ static void fractions(const R& r, const Qm* inv, Qm* q) {
    const uint32_t v5 = r.is_first();
    const uint32_t v6 = 0u;
    const uint32_t v7 = m31::sub(v6, v5);
    const Qm v21 = inv[0];
    const Qm v22 = qm31::qm_mul_m31(v21, v7);
    q[0] = v22;
  }
};

// One component's body whatever the id (the probe below).
template <class C>
struct Only {
  __device__ __forceinline__ static Qm composition(int, const Row& r) { return C::composition(r); }
};

// The composition launch's dispatch: component `id`'s body at one row.
struct Components {
  __device__ __forceinline__ static Qm composition(int id, const Row& r) {
    switch (id) {
      case 0: return MemoryComponent::composition(r);
      case 1: return InstructionComponent::composition(r);
      case 2: return ProgramComponent::composition(r);
      case 3: return ProcessorComponent::composition(r);
      case 4: return JumpIfNotZeroComponent::composition(r);
      case 5: return JumpIfZeroComponent::composition(r);
      case 6: return InputComponent::composition(r);
      case 7: return LeftComponent::composition(r);
      case 8: return MinusComponent::composition(r);
      case 9: return OutputComponent::composition(r);
      case 10: return PlusComponent::composition(r);
      case 11: return RightComponent::composition(r);
      case 12: return EndOfExecutionComponent::composition(r);
    }
    return {0u, 0u, 0u, 0u};
  }
};

}  // namespace
}  // namespace constraints

using namespace constraints;

extern "C" int constraints_components() { return 13; }

extern "C" const char* constraints_component_name(int id) {
  switch (id) {
    case 0: return "memory";
    case 1: return "instruction";
    case 2: return "program";
    case 3: return "processor";
    case 4: return "jump_if_not_zero";
    case 5: return "jump_if_zero";
    case 6: return "input_instruction";
    case 7: return "left_instruction";
    case 8: return "minus_instruction";
    case 9: return "output_instruction";
    case 10: return "plus_instruction";
    case 11: return "right_instruction";
    case 12: return "end_of_execution";
  }
  return "";
}

// out: columns, relations, constraints, pointer slots and own constant
// words of a component in the composition launch.
extern "C" int constraints_shape(int id, int* out) {
  switch (id) {
    case 0: return shape_of<MemoryComponent>(out);
    case 1: return shape_of<InstructionComponent>(out);
    case 2: return shape_of<ProgramComponent>(out);
    case 3: return shape_of<ProcessorComponent>(out);
    case 4: return shape_of<JumpIfNotZeroComponent>(out);
    case 5: return shape_of<JumpIfZeroComponent>(out);
    case 6: return shape_of<InputComponent>(out);
    case 7: return shape_of<LeftComponent>(out);
    case 8: return shape_of<MinusComponent>(out);
    case 9: return shape_of<OutputComponent>(out);
    case 10: return shape_of<PlusComponent>(out);
    case 11: return shape_of<RightComponent>(out);
    case 12: return shape_of<EndOfExecutionComponent>(out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int constraints_composition(const void* table, long long blocks, void* stream) {
  return composition_entry<Components>(table, blocks, stream);
}

// Never launched: the composition kernel with the processor's body alone,
// whose SASS tools/composition_limiter.py reads (a row's instructions of
// one component, the skeleton's included).
__global__ void __launch_bounds__(kThreads) composition_probe_processor(
    const unsigned long long* __restrict__ table) {
  composition_row<Only<ProcessorComponent>>(table);
}

#define ARGS table, n_ptrs, n_words, n, q, total, stream
extern "C" int constraints_logup(int id, const void* table, int n_ptrs, int n_words,
                                 long long n, void* q, void* total, void* stream) {
  switch (id) {
    case 0: return logup_entry<MemoryComponent>(ARGS);
    case 1: return logup_entry<InstructionComponent>(ARGS);
    case 2: return logup_entry<ProgramComponent>(ARGS);
    case 3: return logup_entry<ProcessorComponent>(ARGS);
    case 4: return logup_entry<JumpIfNotZeroComponent>(ARGS);
    case 5: return logup_entry<JumpIfZeroComponent>(ARGS);
    case 6: return logup_entry<InputComponent>(ARGS);
    case 7: return logup_entry<LeftComponent>(ARGS);
    case 8: return logup_entry<MinusComponent>(ARGS);
    case 9: return logup_entry<OutputComponent>(ARGS);
    case 10: return logup_entry<PlusComponent>(ARGS);
    case 11: return logup_entry<RightComponent>(ARGS);
    case 12: return logup_entry<EndOfExecutionComponent>(ARGS);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
#undef ARGS

// out: col_log, row_log, tile_rows, tiles, rows_per_warp, on_chip of an
// interaction launch of 2^log_n rows on the current device, and the
// resident tiles it was planned for.
extern "C" int constraints_interaction_geometry(int id, int log_n, int* out) {
  switch (id) {
    case 0: return interaction_geometry_of<MemoryComponent>(log_n, out);
    case 1: return interaction_geometry_of<InstructionComponent>(log_n, out);
    case 2: return interaction_geometry_of<ProgramComponent>(log_n, out);
    case 3: return interaction_geometry_of<ProcessorComponent>(log_n, out);
    case 4: return interaction_geometry_of<JumpIfNotZeroComponent>(log_n, out);
    case 5: return interaction_geometry_of<JumpIfZeroComponent>(log_n, out);
    case 6: return interaction_geometry_of<InputComponent>(log_n, out);
    case 7: return interaction_geometry_of<LeftComponent>(log_n, out);
    case 8: return interaction_geometry_of<MinusComponent>(log_n, out);
    case 9: return interaction_geometry_of<OutputComponent>(log_n, out);
    case 10: return interaction_geometry_of<PlusComponent>(log_n, out);
    case 11: return interaction_geometry_of<RightComponent>(log_n, out);
    case 12: return interaction_geometry_of<EndOfExecutionComponent>(log_n, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The first n words of the interaction launches' head on the current device.
extern "C" int constraints_head(uint32_t* out, int n) { return logup_scan::head_words(out, n); }

#define ARGS table, n_ptrs, n_words, log_n, q, s, claimed, work, sums, stream
extern "C" int constraints_interaction(int id, const void* table, int n_ptrs, int n_words,
                                       int log_n, void* q, void* s, void* claimed, void* work,
                                       void* sums, void* stream) {
  switch (id) {
    case 0: return interaction_entry<MemoryComponent>(ARGS);
    case 1: return interaction_entry<InstructionComponent>(ARGS);
    case 2: return interaction_entry<ProgramComponent>(ARGS);
    case 3: return interaction_entry<ProcessorComponent>(ARGS);
    case 4: return interaction_entry<JumpIfNotZeroComponent>(ARGS);
    case 5: return interaction_entry<JumpIfZeroComponent>(ARGS);
    case 6: return interaction_entry<InputComponent>(ARGS);
    case 7: return interaction_entry<LeftComponent>(ARGS);
    case 8: return interaction_entry<MinusComponent>(ARGS);
    case 9: return interaction_entry<OutputComponent>(ARGS);
    case 10: return interaction_entry<PlusComponent>(ARGS);
    case 11: return interaction_entry<RightComponent>(ARGS);
    case 12: return interaction_entry<EndOfExecutionComponent>(ARGS);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
#undef ARGS
