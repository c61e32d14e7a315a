"""stwo_brainfuck_tpu_torch: the PyTorch/CUDA port of stwo_brainfuck_tpu.

A Circle-STARK prover and verifier for Brainfuck executions on torch
tensors, with a hand-written CUDA kernel for the circle FFT
(csrc/circle_fft.cu). Module names mirror the JAX package's; the JAX
package is the reference the port is tested against. This package imports
torch and numpy only.
"""

__version__ = "0.1.0"
