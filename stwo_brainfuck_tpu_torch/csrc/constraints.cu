// GENERATED by stwo_brainfuck_tpu_torch/ops/constraint_codegen.py from
// stwo_brainfuck_tpu_torch/components/defs.py; do not edit. Regenerate with
//
//     python -m stwo_brainfuck_tpu_torch.ops.constraint_codegen
//
// The constraint kernels of the 13 components for Hopper (sm_90a): the
// bodies below, one struct a component, plug into the hand-written
// skeletons csrc/constraint_kernel.cuh (composition: one thread a row, the
// loads, the vanishing inverse, the weighted accumulation, the stores;
// logup and interaction: the batched inversion between the denominators
// and the fractions) and csrc/logup_scan.cuh (interaction: the coset
// scan). Each body is the component's recorded constraint program
// (framework/component.py ConstraintProgram), one statement an op.

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

  // sum_i w_i * C_i at one row (w_i the weights in the constant table)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(9);
    const Qm v1 = r.qcol(13);
    const Qm v2 = r.s_prev(17);
    const Qm v3 = r.konst(64);
    const uint32_t v4 = r.col(0);
    const uint32_t v5 = r.col(1);
    const uint32_t v6 = r.col(2);
    const uint32_t v7 = r.col(3);
    const uint32_t v8 = r.col(4);
    const uint32_t v9 = r.col(5);
    const uint32_t v10 = r.col(6);
    const uint32_t v11 = r.col(7);
    const uint32_t v12 = r.col(8);
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
    const Qm v32 = qm31::qm_sub(qm31::qm_add(qm31::qm_add(qm31::qm_mul_m31(r.konst(0), v4), qm31::qm_mul_m31(r.konst(4), v5)), qm31::qm_mul_m31(r.konst(8), v6)), r.konst(12));
    const Qm v33 = qm31::qm_mul(v0, v32);
    const Qm v34 = qm31::qm_sub(v33, qm31::qm_from_m31(v18));
    const Qm v35 = qm31::qm_sub(v1, v2);
    const Qm v36 = qm31::qm_sub(v35, v0);
    const Qm v37 = qm31::qm_mul_m31(v3, v12);
    const Qm v38 = qm31::qm_add(v36, v37);
    Qm acc = qm31::qm_mul_m31(r.konst(68), v13);
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(72), v14));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(76), v15));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(80), v16));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(84), v19));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(88), v21));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(92), v24));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(96), v27));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(100), v28));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(104), v29));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(108), v31));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(112), v34));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(116), v38));
    return acc;
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

  // sum_i w_i * C_i at one row (w_i the weights in the constant table)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(9);
    const Qm v1 = r.qcol(13);
    const Qm v2 = r.s_prev(17);
    const Qm v3 = r.konst(64);
    const uint32_t v4 = r.col(0);
    const uint32_t v5 = r.col(1);
    const uint32_t v6 = r.col(2);
    const uint32_t v7 = r.col(3);
    const uint32_t v8 = r.col(4);
    const uint32_t v9 = r.col(5);
    const uint32_t v10 = r.col(6);
    const uint32_t v11 = r.col(7);
    const uint32_t v12 = r.col(8);
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
    const Qm v30 = qm31::qm_sub(qm31::qm_add(qm31::qm_add(qm31::qm_mul_m31(r.konst(16), v4), qm31::qm_mul_m31(r.konst(20), v5)), qm31::qm_mul_m31(r.konst(24), v6)), r.konst(28));
    const Qm v31 = qm31::qm_mul(v0, v30);
    const Qm v32 = qm31::qm_sub(v31, qm31::qm_from_m31(v15));
    const Qm v33 = qm31::qm_sub(v1, v2);
    const Qm v34 = qm31::qm_sub(v33, v0);
    const Qm v35 = qm31::qm_mul_m31(v3, v12);
    const Qm v36 = qm31::qm_add(v34, v35);
    Qm acc = qm31::qm_mul_m31(r.konst(68), v13);
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(72), v16));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(76), v18));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(80), v19));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(84), v20));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(88), v21));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(92), v22));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(96), v25));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(100), v27));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(104), v29));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(108), v32));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(112), v36));
    return acc;
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

  // sum_i w_i * C_i at one row (w_i the weights in the constant table)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(5);
    const Qm v1 = r.qcol(9);
    const Qm v2 = r.s_prev(13);
    const Qm v3 = r.konst(64);
    const uint32_t v4 = r.col(0);
    const uint32_t v5 = r.col(1);
    const uint32_t v6 = r.col(2);
    const uint32_t v7 = r.col(3);
    const uint32_t v8 = r.col(4);
    const uint32_t v9 = m31::mul(v8, v4);
    const uint32_t v10 = 1u;
    const uint32_t v11 = m31::sub(v7, v10);
    const uint32_t v12 = m31::mul(v7, v11);
    const uint32_t v13 = m31::mul(v7, v5);
    const uint32_t v14 = m31::mul(v7, v6);
    const uint32_t v15 = m31::sub(v10, v7);
    const Qm v16 = qm31::qm_sub(qm31::qm_add(qm31::qm_add(qm31::qm_mul_m31(r.konst(16), v4), qm31::qm_mul_m31(r.konst(20), v5)), qm31::qm_mul_m31(r.konst(24), v6)), r.konst(28));
    const Qm v17 = qm31::qm_mul(v0, v16);
    const Qm v18 = qm31::qm_sub(v17, qm31::qm_from_m31(v15));
    const Qm v19 = qm31::qm_sub(v1, v2);
    const Qm v20 = qm31::qm_sub(v19, v0);
    const Qm v21 = qm31::qm_mul_m31(v3, v8);
    const Qm v22 = qm31::qm_add(v20, v21);
    Qm acc = qm31::qm_mul_m31(r.konst(68), v9);
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(72), v12));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(76), v13));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(80), v14));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(84), v18));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(88), v22));
    return acc;
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

  // sum_i w_i * C_i at one row (w_i the weights in the constant table)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(10);
    const Qm v1 = r.qcol(14);
    const Qm v2 = r.qcol(18);
    const Qm v3 = r.qcol(22);
    const Qm v4 = r.s_prev(26);
    const Qm v5 = r.konst(64);
    const uint32_t v6 = r.col(0);
    const uint32_t v7 = r.col(1);
    const uint32_t v8 = r.col(2);
    const uint32_t v9 = r.col(3);
    const uint32_t v10 = r.col(4);
    const uint32_t v11 = r.col(5);
    const uint32_t v12 = r.col(6);
    const uint32_t v13 = r.col(7);
    const uint32_t v14 = r.col(8);
    const uint32_t v15 = r.col(9);
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
    const Qm v28 = qm31::qm_sub(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_mul_m31(r.konst(32), v6), qm31::qm_mul_m31(r.konst(36), v7)), qm31::qm_mul_m31(r.konst(40), v8)), qm31::qm_mul_m31(r.konst(44), v9)), qm31::qm_mul_m31(r.konst(48), v10)), qm31::qm_mul_m31(r.konst(52), v11)), qm31::qm_mul_m31(r.konst(56), v12)), r.konst(60));
    const Qm v29 = qm31::qm_mul(v0, v28);
    const Qm v30 = qm31::qm_sub(v29, qm31::qm_from_m31(v27));
    const Qm v31 = qm31::qm_sub(qm31::qm_add(qm31::qm_add(qm31::qm_mul_m31(r.konst(16), v7), qm31::qm_mul_m31(r.konst(20), v8)), qm31::qm_mul_m31(r.konst(24), v9)), r.konst(28));
    const Qm v32 = qm31::qm_mul(v1, v31);
    const Qm v33 = qm31::qm_sub(v32, qm31::qm_from_m31(v27));
    const Qm v34 = qm31::qm_add(v0, v1);
    const Qm v35 = qm31::qm_sub(qm31::qm_add(qm31::qm_add(qm31::qm_mul_m31(r.konst(0), v6), qm31::qm_mul_m31(r.konst(4), v10)), qm31::qm_mul_m31(r.konst(8), v11)), r.konst(12));
    const Qm v36 = qm31::qm_mul(v2, v35);
    const Qm v37 = qm31::qm_sub(v36, qm31::qm_from_m31(v27));
    const Qm v38 = qm31::qm_add(v34, v2);
    const Qm v39 = qm31::qm_sub(v3, v4);
    const Qm v40 = qm31::qm_sub(v39, v38);
    const Qm v41 = qm31::qm_mul_m31(v5, v15);
    const Qm v42 = qm31::qm_add(v40, v41);
    Qm acc = qm31::qm_mul_m31(r.konst(68), v16);
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(72), v17));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(76), v18));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(80), v19));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(84), v23));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(88), v24));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(92), v26));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(96), v30));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(100), v33));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(104), v37));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(108), v42));
    return acc;
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

  // sum_i w_i * C_i at one row (w_i the weights in the constant table)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(14);
    const Qm v1 = r.qcol(18);
    const Qm v2 = r.s_prev(22);
    const Qm v3 = r.konst(64);
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
    const Qm v37 = qm31::qm_sub(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_mul_m31(r.konst(32), v4), qm31::qm_mul_m31(r.konst(36), v20)), qm31::qm_mul_m31(r.konst(40), v5)), qm31::qm_mul_m31(r.konst(44), v21)), qm31::qm_mul_m31(r.konst(48), v32)), qm31::qm_mul_m31(r.konst(52), v7)), qm31::qm_mul_m31(r.konst(56), v36)), r.konst(60));
    const Qm v38 = qm31::qm_mul(v0, v37);
    const Qm v39 = qm31::qm_sub(v38, qm31::qm_from_m31(v15));
    const Qm v40 = qm31::qm_sub(v1, v2);
    const Qm v41 = qm31::qm_sub(v40, v0);
    const uint32_t v42 = r.col(13);
    const Qm v43 = qm31::qm_mul_m31(v3, v42);
    const Qm v44 = qm31::qm_add(v41, v43);
    Qm acc = qm31::qm_mul_m31(r.konst(68), v10);
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(72), v14));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(76), v16));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(80), v17));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(84), v18));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(88), v30));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(92), v33));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(96), v35));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(100), v39));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(104), v44));
    return acc;
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

  // sum_i w_i * C_i at one row (w_i the weights in the constant table)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(14);
    const Qm v1 = r.qcol(18);
    const Qm v2 = r.s_prev(22);
    const Qm v3 = r.konst(64);
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
    const Qm v38 = qm31::qm_sub(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_mul_m31(r.konst(32), v4), qm31::qm_mul_m31(r.konst(36), v20)), qm31::qm_mul_m31(r.konst(40), v5)), qm31::qm_mul_m31(r.konst(44), v21)), qm31::qm_mul_m31(r.konst(48), v33)), qm31::qm_mul_m31(r.konst(52), v7)), qm31::qm_mul_m31(r.konst(56), v37)), r.konst(60));
    const Qm v39 = qm31::qm_mul(v0, v38);
    const Qm v40 = qm31::qm_sub(v39, qm31::qm_from_m31(v15));
    const Qm v41 = qm31::qm_sub(v1, v2);
    const Qm v42 = qm31::qm_sub(v41, v0);
    const uint32_t v43 = r.col(13);
    const Qm v44 = qm31::qm_mul_m31(v3, v43);
    const Qm v45 = qm31::qm_add(v42, v44);
    Qm acc = qm31::qm_mul_m31(r.konst(68), v10);
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(72), v14));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(76), v16));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(80), v17));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(84), v18));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(88), v31));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(92), v34));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(96), v36));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(100), v40));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(104), v45));
    return acc;
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

  // sum_i w_i * C_i at one row (w_i the weights in the constant table)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(12);
    const Qm v1 = r.qcol(16);
    const Qm v2 = r.s_prev(20);
    const Qm v3 = r.konst(64);
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
    const Qm v27 = qm31::qm_sub(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_mul_m31(r.konst(32), v24), qm31::qm_mul_m31(r.konst(36), v7)), qm31::qm_mul_m31(r.konst(40), v4)), qm31::qm_mul_m31(r.konst(44), v25)), qm31::qm_mul_m31(r.konst(48), v22)), qm31::qm_mul_m31(r.konst(52), v6)), qm31::qm_mul_m31(r.konst(56), v26)), r.konst(60));
    const Qm v28 = qm31::qm_mul(v0, v27);
    const Qm v29 = qm31::qm_sub(v28, qm31::qm_from_m31(v13));
    const Qm v30 = qm31::qm_sub(v1, v2);
    const Qm v31 = qm31::qm_sub(v30, v0);
    const uint32_t v32 = r.col(11);
    const Qm v33 = qm31::qm_mul_m31(v3, v32);
    const Qm v34 = qm31::qm_add(v31, v33);
    Qm acc = qm31::qm_mul_m31(r.konst(68), v11);
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(72), v14));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(76), v15));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(80), v16));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(84), v20));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(88), v23));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(92), v29));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(96), v34));
    return acc;
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

  // sum_i w_i * C_i at one row (w_i the weights in the constant table)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(12);
    const Qm v1 = r.qcol(16);
    const Qm v2 = r.s_prev(20);
    const Qm v3 = r.konst(64);
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
    const Qm v29 = qm31::qm_sub(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_mul_m31(r.konst(32), v26), qm31::qm_mul_m31(r.konst(36), v7)), qm31::qm_mul_m31(r.konst(40), v4)), qm31::qm_mul_m31(r.konst(44), v27)), qm31::qm_mul_m31(r.konst(48), v22)), qm31::qm_mul_m31(r.konst(52), v6)), qm31::qm_mul_m31(r.konst(56), v28)), r.konst(60));
    const Qm v30 = qm31::qm_mul(v0, v29);
    const Qm v31 = qm31::qm_sub(v30, qm31::qm_from_m31(v13));
    const Qm v32 = qm31::qm_sub(v1, v2);
    const Qm v33 = qm31::qm_sub(v32, v0);
    const uint32_t v34 = r.col(11);
    const Qm v35 = qm31::qm_mul_m31(v3, v34);
    const Qm v36 = qm31::qm_add(v33, v35);
    Qm acc = qm31::qm_mul_m31(r.konst(68), v11);
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(72), v14));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(76), v15));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(80), v16));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(84), v20));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(88), v25));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(92), v31));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(96), v36));
    return acc;
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

  // sum_i w_i * C_i at one row (w_i the weights in the constant table)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(12);
    const Qm v1 = r.qcol(16);
    const Qm v2 = r.s_prev(20);
    const Qm v3 = r.konst(64);
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
    const Qm v31 = qm31::qm_sub(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_mul_m31(r.konst(32), v28), qm31::qm_mul_m31(r.konst(36), v7)), qm31::qm_mul_m31(r.konst(40), v4)), qm31::qm_mul_m31(r.konst(44), v29)), qm31::qm_mul_m31(r.konst(48), v22)), qm31::qm_mul_m31(r.konst(52), v6)), qm31::qm_mul_m31(r.konst(56), v30)), r.konst(60));
    const Qm v32 = qm31::qm_mul(v0, v31);
    const Qm v33 = qm31::qm_sub(v32, qm31::qm_from_m31(v13));
    const Qm v34 = qm31::qm_sub(v1, v2);
    const Qm v35 = qm31::qm_sub(v34, v0);
    const uint32_t v36 = r.col(11);
    const Qm v37 = qm31::qm_mul_m31(v3, v36);
    const Qm v38 = qm31::qm_add(v35, v37);
    Qm acc = qm31::qm_mul_m31(r.konst(68), v11);
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(72), v14));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(76), v15));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(80), v16));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(84), v20));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(88), v23));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(92), v27));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(96), v33));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(100), v38));
    return acc;
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

  // sum_i w_i * C_i at one row (w_i the weights in the constant table)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(12);
    const Qm v1 = r.qcol(16);
    const Qm v2 = r.s_prev(20);
    const Qm v3 = r.konst(64);
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
    const Qm v29 = qm31::qm_sub(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_mul_m31(r.konst(32), v26), qm31::qm_mul_m31(r.konst(36), v7)), qm31::qm_mul_m31(r.konst(40), v4)), qm31::qm_mul_m31(r.konst(44), v27)), qm31::qm_mul_m31(r.konst(48), v22)), qm31::qm_mul_m31(r.konst(52), v6)), qm31::qm_mul_m31(r.konst(56), v28)), r.konst(60));
    const Qm v30 = qm31::qm_mul(v0, v29);
    const Qm v31 = qm31::qm_sub(v30, qm31::qm_from_m31(v13));
    const Qm v32 = qm31::qm_sub(v1, v2);
    const Qm v33 = qm31::qm_sub(v32, v0);
    const uint32_t v34 = r.col(11);
    const Qm v35 = qm31::qm_mul_m31(v3, v34);
    const Qm v36 = qm31::qm_add(v33, v35);
    Qm acc = qm31::qm_mul_m31(r.konst(68), v11);
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(72), v14));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(76), v15));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(80), v16));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(84), v20));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(88), v23));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(92), v25));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(96), v31));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(100), v36));
    return acc;
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

  // sum_i w_i * C_i at one row (w_i the weights in the constant table)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(12);
    const Qm v1 = r.qcol(16);
    const Qm v2 = r.s_prev(20);
    const Qm v3 = r.konst(64);
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
    const Qm v31 = qm31::qm_sub(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_mul_m31(r.konst(32), v28), qm31::qm_mul_m31(r.konst(36), v7)), qm31::qm_mul_m31(r.konst(40), v4)), qm31::qm_mul_m31(r.konst(44), v29)), qm31::qm_mul_m31(r.konst(48), v22)), qm31::qm_mul_m31(r.konst(52), v6)), qm31::qm_mul_m31(r.konst(56), v30)), r.konst(60));
    const Qm v32 = qm31::qm_mul(v0, v31);
    const Qm v33 = qm31::qm_sub(v32, qm31::qm_from_m31(v13));
    const Qm v34 = qm31::qm_sub(v1, v2);
    const Qm v35 = qm31::qm_sub(v34, v0);
    const uint32_t v36 = r.col(11);
    const Qm v37 = qm31::qm_mul_m31(v3, v36);
    const Qm v38 = qm31::qm_add(v35, v37);
    Qm acc = qm31::qm_mul_m31(r.konst(68), v11);
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(72), v14));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(76), v15));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(80), v16));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(84), v20));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(88), v23));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(92), v27));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(96), v33));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(100), v38));
    return acc;
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

  // sum_i w_i * C_i at one row (w_i the weights in the constant table)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(12);
    const Qm v1 = r.qcol(16);
    const Qm v2 = r.s_prev(20);
    const Qm v3 = r.konst(64);
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
    const Qm v29 = qm31::qm_sub(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_mul_m31(r.konst(32), v26), qm31::qm_mul_m31(r.konst(36), v7)), qm31::qm_mul_m31(r.konst(40), v4)), qm31::qm_mul_m31(r.konst(44), v27)), qm31::qm_mul_m31(r.konst(48), v22)), qm31::qm_mul_m31(r.konst(52), v6)), qm31::qm_mul_m31(r.konst(56), v28)), r.konst(60));
    const Qm v30 = qm31::qm_mul(v0, v29);
    const Qm v31 = qm31::qm_sub(v30, qm31::qm_from_m31(v13));
    const Qm v32 = qm31::qm_sub(v1, v2);
    const Qm v33 = qm31::qm_sub(v32, v0);
    const uint32_t v34 = r.col(11);
    const Qm v35 = qm31::qm_mul_m31(v3, v34);
    const Qm v36 = qm31::qm_add(v33, v35);
    Qm acc = qm31::qm_mul_m31(r.konst(68), v11);
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(72), v14));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(76), v15));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(80), v16));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(84), v20));
    acc = qm31::qm_add(acc, qm31::qm_mul_m31(r.konst(88), v25));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(92), v31));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(96), v36));
    return acc;
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

  // sum_i w_i * C_i at one row (w_i the weights in the constant table)
  __device__ __forceinline__ static Qm composition(const Row& r) {
    const Qm v0 = r.qcol(8);
    const Qm v1 = r.qcol(12);
    const Qm v2 = r.s_prev(16);
    const Qm v3 = r.konst(64);
    const uint32_t v4 = r.col(2);
    const uint32_t v5 = r.col(7);
    const uint32_t v6 = 0u;
    const uint32_t v7 = m31::sub(v6, v5);
    const uint32_t v8 = r.col(0);
    const uint32_t v9 = r.col(1);
    const uint32_t v10 = r.col(3);
    const uint32_t v11 = r.col(4);
    const uint32_t v12 = r.col(5);
    const uint32_t v13 = r.col(6);
    const Qm v14 = qm31::qm_sub(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_add(qm31::qm_mul_m31(r.konst(32), v8), qm31::qm_mul_m31(r.konst(36), v9)), qm31::qm_mul_m31(r.konst(40), v4)), qm31::qm_mul_m31(r.konst(44), v10)), qm31::qm_mul_m31(r.konst(48), v11)), qm31::qm_mul_m31(r.konst(52), v12)), qm31::qm_mul_m31(r.konst(56), v13)), r.konst(60));
    const Qm v15 = qm31::qm_mul(v0, v14);
    const Qm v16 = qm31::qm_sub(v15, qm31::qm_from_m31(v7));
    const Qm v17 = qm31::qm_sub(v1, v2);
    const Qm v18 = qm31::qm_sub(v17, v0);
    const Qm v19 = qm31::qm_mul_m31(v3, v5);
    const Qm v20 = qm31::qm_add(v18, v19);
    Qm acc = qm31::qm_mul_m31(r.konst(68), v4);
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(72), v16));
    acc = qm31::qm_add(acc, qm31::qm_mul(r.konst(76), v20));
    return acc;
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

// out: columns, relations, constraints, pointer slots of a composition
// launch, constant words of a composition launch before V_n^-1's.
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

#define ARGS table, n_ptrs, n_words, rot, log_size, log_blowup, offset, n, acc, accumulate, stream
extern "C" int constraints_composition(int id, const void* table, int n_ptrs, int n_words,
                                       const void* rot, int log_size, int log_blowup,
                                       long long offset, long long n, void* acc, int accumulate,
                                       void* stream) {
  switch (id) {
    case 0: return composition_entry<MemoryComponent>(ARGS);
    case 1: return composition_entry<InstructionComponent>(ARGS);
    case 2: return composition_entry<ProgramComponent>(ARGS);
    case 3: return composition_entry<ProcessorComponent>(ARGS);
    case 4: return composition_entry<JumpIfNotZeroComponent>(ARGS);
    case 5: return composition_entry<JumpIfZeroComponent>(ARGS);
    case 6: return composition_entry<InputComponent>(ARGS);
    case 7: return composition_entry<LeftComponent>(ARGS);
    case 8: return composition_entry<MinusComponent>(ARGS);
    case 9: return composition_entry<OutputComponent>(ARGS);
    case 10: return composition_entry<PlusComponent>(ARGS);
    case 11: return composition_entry<RightComponent>(ARGS);
    case 12: return composition_entry<EndOfExecutionComponent>(ARGS);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
#undef ARGS

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
