"""ShardedOps: the multi-device backend of prove_brainfuck.

Counterpart of ``stwo_brainfuck_tpu/parallel/prove.py``.
``air.prove_brainfuck(machine, mesh=mesh)`` routes every heavy phase
through this object:

- LogUp fractions and prefix sums: per shard, with the permutation to and
  from linear order as a global gather (``Mesh.permute``) and the shard
  totals all-gathered (parallel/sharded.py);
- circle-FFT interpolate / extend / evaluate: parallel/fft_sharded.py (the
  FFT kernel on every shard's local stages, exchanges for the cross-shard
  stages);
- Merkle commitments: parallel/merkle_sharded.commit_sharded;
- composition constraints, quotient accumulation and OODS sampling: per
  shard (the samples as per-shard partial contractions summed mod p);
- FRI folds: per shard (fold pairs are adjacent in bit-reversed storage,
  so a shard's chunk folds to a chunk, until the layer is smaller than the
  mesh and finishes on the first device).

All arithmetic is exact mod p, so the proof bytes are those of the
single-device proof for any number of shards. Arrays with fewer than 2
rows a shard stay on the single-device path, on the mesh's first device.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List

import torch

from ..core import fft, fri, merkle, poly, quotients
from ..core.m31 import P_INT
from ..framework.component import build_interaction_trace, composition_contribution
from .fft_sharded import make_sharded_evaluate, make_sharded_interpolate, sharded_extend
from .merkle_sharded import commit_sharded
from .mesh import Mesh, Permutation, Sharded
from .sharded import fractions, prefix_sum, shard_elements


@lru_cache(maxsize=32)
def _permutation(mesh: Mesh, kind: str, log_size: int, log_blowup: int = 0) -> Permutation:
    """The global gathers of the prover, split into per-shard moves:
    "linear" (storage -> coset linear order), "storage" (its inverse) and
    "rotation" (f(p - g) on the blown-up domain)."""
    dev = mesh.devices[0]
    if kind == "rotation":
        perm = fft.rotation_permutation(log_size, log_blowup, 1, dev)
    else:
        perm = fft.coset_order_permutation(log_size, dev)
        if kind == "storage":
            perm = torch.argsort(perm)
    return Permutation(mesh, perm)


def _int32(shards: List[torch.Tensor]) -> List[torch.Tensor]:
    return [s.to(torch.int32) for s in shards]


class ShardedOps:
    """Multi-device implementations of the prove pipeline's primitives.
    Each takes tensors or Sharded arrays and returns Sharded arrays where
    the size shards (at least 2 rows a shard), else tensors on the mesh's
    first device (the same values either way)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.D = mesh.size
        self.split_log = mesh.split_log

    def _shardable(self, log_size: int) -> bool:
        return log_size >= self.split_log + 1

    # -- FFT ---------------------------------------------------------------

    def interpolate(self, values, log_size: int):
        if not self._shardable(log_size):
            return fft.interpolate(self.mesh.full(values), log_size)
        return make_sharded_interpolate(self.mesh, log_size)(values)

    def evaluate(self, coeffs, log_size: int):
        if not self._shardable(log_size):
            return fft.evaluate(self.mesh.full(coeffs), log_size)
        return make_sharded_evaluate(self.mesh, log_size)(coeffs)

    def extend_with_coeffs(self, values, log_size: int, blow: int):
        """(coefficients, blown-up evaluation) of a (C, N) array or a list
        of (N,) columns."""
        if isinstance(values, (list, tuple)):
            values = self.mesh.stack(values)
        if not self._shardable(log_size):
            return fft.extend_with_coeffs(self.mesh.full(values), log_size, blow)
        return sharded_extend(self.mesh, values, log_size, blow)

    def combine_eval(self, acc: Dict[int, list], comp_log: int):
        """The composition evaluation: per size the sum of the
        contributions, interpolated; zero-padded to 2^comp_log and added;
        evaluated on the composition domain."""
        total = None
        for lg, arrs in sorted(acc.items()):
            coeffs = self.interpolate(self._sum(arrs, lg), lg)
            if self._shardable(comp_log):
                padded = self.mesh.pad(coeffs, comp_log)
            else:
                padded = torch.zeros((4, 1 << comp_log), dtype=torch.int32,
                                     device=self.mesh.devices[0])
                padded[:, :1 << lg] = coeffs
            total = padded if total is None else self._add(total, padded)
        return self.evaluate(total, comp_log)

    def _sum(self, arrs: list, log_size: int):
        """The mod-p sum of equal-size arrays, int32: Sharded if the size
        shards, else a tensor."""
        if not self._shardable(log_size):
            total = sum(self.mesh.full(a).to(torch.int64) for a in arrs) % P_INT
            return total.to(torch.int32)
        arrs = [self.mesh.as_sharded(a) for a in arrs]
        return Sharded(self.mesh, _int32([sum(a.shards[i].to(torch.int64) for a in arrs) % P_INT
                                          for i in range(self.D)]))

    def _add(self, a, b):
        if isinstance(a, torch.Tensor):
            return ((a.to(torch.int64) + b) % P_INT).to(torch.int32)
        return Sharded(self.mesh, _int32([(x.to(torch.int64) + y) % P_INT
                                          for x, y in zip(a.shards, b.shards)]))

    # -- Merkle ------------------------------------------------------------

    def commit(self, columns_by_log: Dict[int, object]) -> merkle.MerkleTree:
        if not self._shardable(max(columns_by_log)):
            return merkle.commit({k: self.mesh.full(v) for k, v in columns_by_log.items()})
        return commit_sharded(self.mesh, columns_by_log)

    # -- LogUp interaction -------------------------------------------------

    def interaction(self, component, main_cols: Dict[str, torch.Tensor], elements):
        """build_interaction_trace over the mesh: ([Q_0..Q_{K-1}, S], each
        a (4, N) int32 array, claimed sum host tuple). The fractions are
        pointwise per shard; the prefix sum runs in linear order (a global
        gather there and back)."""
        log_size = component.log_size
        if not self._shardable(log_size):
            return build_interaction_trace(
                component, {k: self.mesh.full(v) for k, v in main_cols.items()}, elements)
        mesh = self.mesh
        main = {k: mesh.as_sharded(v) for k, v in main_cols.items()}
        is_first = torch.zeros(1 << log_size, dtype=torch.int64, device=mesh.devices[0])
        is_first[0] = 1
        q_cols, totals = fractions(mesh, component, main, mesh.shard(is_first),
                                   shard_elements(mesh, elements))
        lin = mesh.permute(totals, _permutation(mesh, "linear", log_size))
        s_lin, claimed = prefix_sum(mesh, lin)
        s = mesh.permute(s_lin, _permutation(mesh, "storage", log_size))
        cols = [Sharded(mesh, [q[k] for q in q_cols]) for k in range(len(q_cols[0]))]
        return cols + [Sharded(mesh, _int32(s))], claimed

    # -- Composition -------------------------------------------------------

    def rotate(self, values, log_size: int, log_blowup: int):
        """values (4, 2^(log_size+log_blowup)) at p - g: the mask of the
        prefix-sum column (fft.rotation_permutation as a global gather)."""
        if not self._shardable(log_size):
            full = self.mesh.full(values)
            return full[:, fft.rotation_permutation(log_size, log_blowup, 1, full.device)]
        perm = _permutation(self.mesh, "rotation", log_size, log_blowup)
        return Sharded(self.mesh, self.mesh.permute(self.mesh.as_sharded(values).shards, perm))

    def composition_contribution(self, component, ext_main, ext_inter, s_prev, isf_ext,
                                 claimed_sum, elements, alpha, alpha_offset, v_inv):
        """framework.composition_contribution on every shard's rows of the
        blown-up domain: ((4, N) int32, next alpha offset)."""
        if not self._shardable(component.log_size):
            f = self.mesh.full
            return composition_contribution(
                component, {k: f(v) for k, v in ext_main.items()}, [f(x) for x in ext_inter],
                f(s_prev), f(isf_ext), claimed_sum, elements, alpha, alpha_offset, f(v_inv))
        sh = self.mesh.as_sharded
        main = {k: sh(v) for k, v in ext_main.items()}
        inter = [sh(x) for x in ext_inter]
        s_prev, isf_ext, v_inv = sh(s_prev), sh(isf_ext), sh(v_inv)
        outs = []
        for i in range(self.D):
            out, nxt = composition_contribution(
                component, {k: v.shards[i] for k, v in main.items()},
                [x.shards[i] for x in inter], s_prev.shards[i], isf_ext.shards[i],
                claimed_sum, elements, alpha, alpha_offset, v_inv.shards[i])
            outs.append(out.to(torch.int32))
        return Sharded(self.mesh, outs), nxt

    # -- OODS --------------------------------------------------------------

    def sample_tensor(self, rows, b_lo, b_hi) -> torch.Tensor:
        """poly.sample_tensor of rows that may be Sharded: each shard's
        partial contraction, summed mod p. (4, C) int64 on the first
        device."""
        dev = self.mesh.devices[0]
        plain = [k for k, r in enumerate(rows) if isinstance(r, torch.Tensor)]
        spread = [k for k, r in enumerate(rows) if not isinstance(r, torch.Tensor)]
        out = torch.empty((4, len(rows)), dtype=torch.int64, device=dev)
        if plain:
            out[:, plain] = poly.sample_tensor([rows[k] for k in plain], b_lo, b_hi).to(dev)
        if spread:
            chunk = rows[spread[0]].chunk
            parts = [poly.sample_tensor([rows[k].shards[i] for k in spread], b_lo, b_hi,
                                        offset=i * chunk).to(dev) for i in range(self.D)]
            out[:, spread] = sum(parts) % P_INT
        return out

    # -- Quotients ---------------------------------------------------------

    def accumulate_all(self, log_size: int, columns, groups) -> object:
        """quotients.accumulate_groups on every shard's chunk of the
        domain."""
        dev = self.mesh.devices[0]
        px, py = quotients.domain_points_storage(log_size, dev)
        if not self._shardable(log_size):
            return quotients.accumulate_groups([self.mesh.full(c) for c in columns], groups, px, py)
        cols = [self.mesh.as_sharded(c) for c in columns]
        px, py = self.mesh.shard(px), self.mesh.shard(py)
        return Sharded(self.mesh, [
            quotients.accumulate_groups([c.shards[i] for c in cols], groups,
                                        px.shards[i], py.shards[i])
            for i in range(self.D)])

    # -- FRI ---------------------------------------------------------------

    def fold(self, values, itw, beta):
        """One FRI fold (4, 2M) -> (4, M), int32."""
        if values.shape[1] // 2 < 2 * self.D:
            return fri._fold(self.mesh.full(values), itw, beta).to(torch.int32)
        v, t = self.mesh.as_sharded(values), self.mesh.shard(itw)
        return Sharded(self.mesh, _int32([fri._fold(a, b, beta)
                                          for a, b in zip(v.shards, t.shards)]))

    def fold2(self, values, itw1, itw2, beta, beta2):
        """Two folds (beta, then beta2): a radix-4 layer's body."""
        if values.shape[1] // 4 < 2 * self.D:
            full = fri._fold(fri._fold(self.mesh.full(values), itw1, beta), itw2, beta2)
            return full.to(torch.int32)
        v = self.mesh.as_sharded(values)
        t1, t2 = self.mesh.shard(itw1), self.mesh.shard(itw2)
        return Sharded(self.mesh, _int32([fri._fold(fri._fold(a, b, beta), c, beta2)
                                          for a, b, c in zip(v.shards, t1.shards, t2.shards)]))

    def fold_add(self, values, itw, beta, cur):
        """cur + fold(values): an injected FRI input."""
        if values.shape[1] // 2 < 2 * self.D:
            folded = fri._fold(self.mesh.full(values), itw, beta)
            return ((self.mesh.full(cur).to(torch.int64) + folded) % P_INT).to(torch.int32)
        v, t = self.mesh.as_sharded(values), self.mesh.shard(itw)
        c = self.mesh.as_sharded(cur)
        return Sharded(self.mesh, _int32([(x.to(torch.int64) + fri._fold(a, b, beta)) % P_INT
                                          for x, a, b in zip(c.shards, v.shards, t.shards)]))
