"""Tests that need a CUDA GPU (marker `gpu`; skipped without one). They
import no jax, so on a machine with a card and no jax they run with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from stwo_brainfuck_tpu_torch import air
from stwo_brainfuck_tpu_torch.core import fft
from stwo_brainfuck_tpu_torch.ops import circle_fft
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine

pytestmark = pytest.mark.gpu
P = 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the circle FFT kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 4, 11, 12, 13, 19, 20])
def test_kernel_matches_plain_on_the_card(cuda, n):
    x = torch.as_tensor(np.random.default_rng(n).integers(0, P, (3, 1 << n)).astype(np.int32),
                        device=cuda)
    before = circle_fft.KERNEL.launches
    assert torch.equal(circle_fft.evaluate(x, n), fft.evaluate_plain(x, n))
    assert torch.equal(circle_fft.interpolate(x, n), fft.interpolate_plain(x, n))
    assert torch.equal(circle_fft.evaluate(x[0], n), fft.evaluate_plain(x[0], n))
    assert circle_fft.KERNEL.launches - before == 3 * len(circle_fft.pass_plan(n, False))


def test_kernel_wrapper_refuses_what_it_cannot_take(cuda):
    x = torch.zeros((4, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        circle_fft.evaluate(x[:, ::2], 5)       # not contiguous
    with pytest.raises(TypeError):
        circle_fft.evaluate(x.to(torch.int64), 6)


def test_small_proof_on_the_card_matches_jax_reference(cuda):
    m = create_test_machine(compile_program(chip_smoke.SMALL_CODE),
                            chip_smoke.SMALL_INPUT.encode())
    m.execute()
    fft.PLAIN_CUDA_CALLS = 0
    proof = air.prove_brainfuck(m, device=cuda)
    assert fft.PLAIN_CUDA_CALLS == 0
    assert chip_smoke.proof_sha256(proof) == chip_smoke.REFERENCE_SHA256["small"]
    air.verify_brainfuck(proof, device=cuda)
