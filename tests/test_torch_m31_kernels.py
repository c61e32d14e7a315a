"""The port's M31 kernel module (ops/m31_kernels.py) vs the JAX package's
ops/m31_pallas.py, on the CPU, with tolerance 0 (exact field arithmetic):
the plain versions and the kernels' arithmetic replay (`emulate`) against
the JAX wrappers (their jnp path) and against the three Pallas kernel
bodies run in interpret mode; the wrapper's dispatch and checks; and the
shared nvcc build helper's cache key."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from stwo_brainfuck_tpu.ops import m31_pallas
from stwo_brainfuck_tpu_torch.ops import m31_kernels, nvcc

torch.set_num_threads(1)
P = 2**31 - 1
EDGES = np.array([0, 1, 2, 2**16 - 1, 2**16, 2**30, P - 2, P - 1], np.uint32)


def _values(seed, shape):
    """Random canonical values with every pair of edge values in front."""
    x = np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint32).reshape(-1)
    k = min(x.size, EDGES.size ** 2)
    pairs = (np.repeat(EDGES, EDGES.size) if seed % 2 else np.tile(EDGES, EDGES.size))[:k]
    x[:k] = pairs
    return x.reshape(shape)


def _t(x):
    return torch.as_tensor(x.astype(np.int32))


def _u(t):
    return t.numpy().astype(np.int64)


def _jax(kind, a, b, c=None, chain=8):
    if kind == "mul":
        return np.asarray(m31_pallas.mul(jnp.asarray(a), jnp.asarray(b)))
    if kind == "mul_add":
        return np.asarray(m31_pallas.mul_add(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    return np.asarray(m31_pallas.mul_chain(jnp.asarray(a), jnp.asarray(b), chain))


def _port(kind, a, b, c=None, chain=8):
    if kind == "mul":
        return m31_kernels.mul(_t(a), _t(b))
    if kind == "mul_add":
        return m31_kernels.mul_add(_t(a), _t(b), _t(c))
    return m31_kernels.mul_chain(_t(a), _t(b), chain)


CASES = [("mul", 1), ("mul_add", 1), ("mul_chain", 1), ("mul_chain", 8), ("mul_chain", 13)]


@pytest.mark.parametrize("kind,chain", CASES)
@pytest.mark.parametrize("n", [1, 127, 128, 4097])
def test_plain_and_emulate_match_jax_wrappers(kind, chain, n):
    a, b, c = (_values(s, (n,)) for s in (n, n + 1, n + 2))
    want = _jax(kind, a, b, c, chain).astype(np.int64)
    before = dict(m31_kernels.KERNELS.launches)
    got = _port(kind, a, b, c, chain)
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(_u(got), want)
    emu = m31_kernels.emulate(kind, _t(a), _t(b), _t(c), chain=chain)
    np.testing.assert_array_equal(emu.numpy(), want)
    assert m31_kernels.KERNELS.launches == before  # CPU tensors never launch


def _interpret(kernel, *xs):
    rows = xs[0].shape[0]
    spec = pl.BlockSpec((8, 128), lambda i: (i, 0))
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.uint32),
        grid=(rows // 8,), in_specs=[spec] * len(xs), out_specs=spec,
        interpret=True)(*(jnp.asarray(x) for x in xs)))


@pytest.mark.parametrize("kind,chain", [("mul", 1), ("mul_add", 1), ("mul_chain", 8)])
def test_emulate_matches_pallas_kernel_bodies(kind, chain):
    a, b, c = (_values(s, (16, 128)) for s in (7, 8, 9))
    if kind == "mul":
        want = _interpret(m31_pallas._mul_kernel, a, b)
    elif kind == "mul_add":
        want = _interpret(m31_pallas._mul_add_kernel, a, b, c)
    else:
        want = _interpret(partial(m31_pallas._mul_chain_kernel, chain=chain), a, b)
    want = want.astype(np.int64)
    np.testing.assert_array_equal(m31_kernels.emulate(kind, _t(a), _t(b), _t(c),
                                                      chain=chain).numpy(), want)
    np.testing.assert_array_equal(_u(_port(kind, a, b, c, chain)), want)


def test_edge_products_are_canonical():
    a = np.array([0, 5, P - 1, P - 1, 2**16, 1], np.uint32)
    b = np.array([7, 0, P - 1, 1, 2**16, 1], np.uint32)
    want = np.array([0, 0, 1, P - 1, 2**32 % P, 1])
    np.testing.assert_array_equal(_u(m31_kernels.mul(_t(a), _t(b))), want)
    np.testing.assert_array_equal(m31_kernels.emulate("mul", _t(a), _t(b)).numpy(), want)
    # a*b + c reaching p exactly gives 0, never p
    a2 = np.array([P - 1, 1, 2, P - 1], np.uint32)
    b2 = np.array([1, P - 1, (P + 1) // 2, P - 1], np.uint32)
    c2 = np.array([1, 1, P - 1, P - 1], np.uint32)
    want2 = np.array([0, 0, 0, 0])
    np.testing.assert_array_equal(_u(m31_kernels.mul_add(_t(a2), _t(b2), _t(c2))), want2)
    np.testing.assert_array_equal(
        m31_kernels.emulate("mul_add", _t(a2), _t(b2), _t(c2)).numpy(), want2)


@pytest.mark.parametrize("kind", ["mul", "mul_add", "mul_chain"])
def test_broadcast_matches_jax(kind):
    a, b, c = _values(1, (4, 1)), _values(2, (1, 256)), _values(3, (256,))
    got = _port(kind, a, b, c)
    want = _jax(kind, a, b, c)
    assert got.shape == (4, 256) and want.shape == (4, 256)
    np.testing.assert_array_equal(_u(got), want.astype(np.int64))


def test_wrappers_refuse_what_the_kernels_cannot_take():
    x = torch.ones(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        m31_kernels.mul(x.to(torch.int64), x)
    with pytest.raises(TypeError):
        m31_kernels.mul_add(x, x, x.to(torch.int64))
    with pytest.raises(TypeError):
        m31_kernels.mul_chain(x, 3)
    with pytest.raises(ValueError):
        m31_kernels.mul(x.to("meta"), x.to("meta"))
    with pytest.raises(ValueError):
        m31_kernels.mul_chain(x, x, -1)
    with pytest.raises(ValueError):
        m31_kernels.KERNELS.run("mul", x, x)  # a CPU tensor never reaches the kernel


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    calls = []
    for name in ("mul_plain", "mul_add_plain", "mul_chain_plain"):
        fn = getattr(m31_kernels, name)
        monkeypatch.setattr(m31_kernels, name,
                            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    x = _t(_values(4, (64,)))
    guard = m31_kernels.PLAIN_CUDA_CALLS
    m31_kernels.mul(x, x)
    m31_kernels.mul_add(x, x, x)
    m31_kernels.mul_chain(x, x, 3)
    assert calls == ["mul_plain", "mul_add_plain", "mul_chain_plain"]
    assert m31_kernels.PLAIN_CUDA_CALLS == guard


def test_throughput_benchmark_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        m31_kernels.throughput_benchmark(4, 1, 2)


def test_library_name_follows_source_headers_and_flags(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// kernel\n")
    (tmp_path / "f.cuh").write_text("// header\n")
    monkeypatch.setattr(nvcc, "CSRC", tmp_path)
    lib = nvcc.CudaLibrary("k", lambda _: None)
    first = lib.path()
    assert first.parent == nvcc.BUILD_DIR and first.name.startswith("libk-")
    assert lib.path() == first
    (tmp_path / "f.cuh").write_text("// header, changed\n")
    second = lib.path()
    assert second != first
    monkeypatch.setattr(nvcc, "NVCC_FLAGS", nvcc.NVCC_FLAGS + ["-lineinfo"])
    assert lib.path() != second
