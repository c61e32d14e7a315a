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
  shard (the samples of every group as one partial contraction a shard,
  one mesh sum, mod p);
- FRI folds: one fold step a shard between committed layers (fold pairs
  are adjacent in bit-reversed storage, so a shard's chunk folds to a
  chunk, until the layer is smaller than the mesh and finishes whole).

Each process works on the shards it owns (``Mesh.each``). All arithmetic
is exact mod p, so the proof bytes are those of the single-device proof for
any number of shards and processes. Arrays with fewer than 2 rows a shard
stay on the single-device path: the whole array (``Mesh.full``) in every
process, on its own device, so every process computes the same values.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict

import torch

from ..core import fft, fri, merkle, poly, quotients
from ..core.m31 import P_INT
from ..framework.component import (CompositionMember, CompositionSegment,
                                   build_interaction_trace_async, composition_evaluate)
from ..ops import mesh_kernels
from .fft_sharded import make_sharded_evaluate, make_sharded_interpolate, sharded_extend
from .merkle_sharded import commit_sharded
from .mesh import Mesh, Permutation, Sharded
from .sharded import fractions, prefix_sum


@lru_cache(maxsize=32)
def _permutation(mesh: Mesh, kind: str, log_size: int, log_blowup: int = 0) -> Permutation:
    """The global gathers of the prover, split into per-shard moves:
    "linear" (storage -> coset linear order), "storage" (its inverse) and
    "rotation" (f(p - g) on the blown-up domain)."""
    dev = mesh.home
    if kind == "rotation":
        perm = fft.rotation_permutation(log_size, log_blowup, 1, dev)
    else:
        perm = fft.coset_order_permutation(log_size, dev)
        if kind == "storage":
            perm = torch.argsort(perm)
    return Permutation(mesh, perm)


class ShardedOps:
    """Multi-device implementations of the prove pipeline's primitives.
    Each takes tensors or Sharded arrays and returns Sharded arrays where
    the size shards (at least 2 rows a shard), else tensors on the mesh's
    home device, the same in every process (the same values either way)."""

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

    def evaluate(self, coeffs, log_size: int, consume: bool = False):
        """The evaluation of `coeffs`; with `consume` a Sharded input is
        given up to the transform, which overwrites its shards."""
        if not self._shardable(log_size):
            return fft.evaluate(self.mesh.full(coeffs), log_size)
        return make_sharded_evaluate(self.mesh, log_size)(coeffs, consume=consume)

    def extend_with_coeffs(self, values, log_size: int, blow: int):
        """(coefficients, blown-up evaluation) of a (C, N) array or a list
        of (N,) columns."""
        if isinstance(values, (list, tuple)):
            values = self.mesh.stack(values)
        if not self._shardable(log_size):
            return fft.extend_with_coeffs(self.mesh.full(values), log_size, blow)
        return sharded_extend(self.mesh, values, log_size, blow)

    def combine_eval(self, acc: Dict[int, object], comp_log: int):
        """The composition evaluation: per size the accumulated
        contributions (composition), interpolated; zero-padded
        to 2^comp_log and added (in place on the first padded array);
        evaluated on the composition domain, in place on the sum."""
        total = None
        for lg, arr in sorted(acc.items()):
            coeffs = self.interpolate(self.mesh.as_sharded(arr) if self._shardable(lg) else arr,
                                      lg)
            if self._shardable(comp_log):
                padded = self.mesh.pad(coeffs, comp_log)
            else:
                padded = torch.zeros((4, 1 << comp_log), dtype=torch.int32,
                                     device=self.mesh.home)
                padded[:, :1 << lg] = coeffs
            total = padded if total is None else self._add(total, padded)
        return self.evaluate(total, comp_log, consume=True)

    def _add(self, a, b):
        """a + b mod p; a Sharded `a` (a padded array this object made) is
        overwritten, shard by shard, with the mesh-stage kernel on a card."""
        if isinstance(a, torch.Tensor):
            return ((a.to(torch.int64) + b) % P_INT).to(torch.int32)
        for i in self.mesh.local:
            mesh_kernels.add_into(a.shards[i], b.shards[i])
        return a

    # -- Merkle ------------------------------------------------------------

    def commit(self, columns_by_log: Dict[int, object]) -> merkle.MerkleTree:
        if not self._shardable(max(columns_by_log)):
            return merkle.commit({k: self.mesh.full(v) for k, v in columns_by_log.items()})
        return commit_sharded(self.mesh, columns_by_log)

    # -- LogUp interaction -------------------------------------------------

    def interaction(self, component, main_cols: Dict[str, torch.Tensor], elements):
        """build_interaction_trace_async over the mesh: ([Q_0..Q_{K-1}, S],
        each a (4, N) int32 array, the claimed sum a (4,) int32 tensor on
        the home device). The fractions are pointwise per shard; the prefix
        sum runs in linear order (a global gather there and back), a scan
        launch a shard with its carry-in."""
        log_size = component.log_size
        if not self._shardable(log_size):
            return build_interaction_trace_async(
                component, {k: self.mesh.full(v) for k, v in main_cols.items()}, elements)
        mesh = self.mesh
        main = {k: mesh.as_sharded(v) for k, v in main_cols.items()}
        is_first = torch.zeros(1 << log_size, dtype=torch.int32, device=mesh.home)
        is_first[0] = 1
        q_cols, totals = fractions(mesh, component, main, mesh.shard(is_first), elements)
        lin = mesh.permute(totals, _permutation(mesh, "linear", log_size))
        s_lin, claimed = prefix_sum(mesh, lin)
        s = mesh.permute(s_lin, _permutation(mesh, "storage", log_size))
        n_q = len(q_cols[mesh.local[0]])
        cols = [Sharded(mesh, mesh.each(lambda i: q_cols[i][k])) for k in range(n_q)]
        return cols + [Sharded(mesh, s)], claimed

    # -- Composition -------------------------------------------------------

    def rotate(self, values, log_size: int, log_blowup: int):
        """values (4, 2^(log_size+log_blowup)) at p - g: the mask of the
        prefix-sum column (fft.rotation_permutation as a global gather)."""
        if not self._shardable(log_size):
            full = self.mesh.full(values)
            return full[:, fft.rotation_permutation(log_size, log_blowup, 1, full.device)]
        perm = _permutation(self.mesh, "rotation", log_size, log_blowup)
        return Sharded(self.mesh, self.mesh.permute(self.mesh.as_sharded(values).shards, perm))

    def composition(self, members: Dict[int, list], is_first: Dict[int, object], elements,
                    alpha, log_blowup: int) -> Dict[int, object]:
        """framework.composition_evaluate over the mesh: `members` the
        CompositionMembers of each log_size in the claim's order (their rows
        on the mesh, Sharded or not), `is_first` each size's is_first rows.
        A sharded size is a segment a shard at its chunk's offset, S(p - g)
        from the rotation's global gather; a size below the sharded sizes
        one segment on the home device, read through the rotation index.
        One call (one kernel launch on a card) a device over its
        segments. Returns log_size + log_blowup -> a Sharded (4, N) int32
        array, or a tensor below the sharded sizes."""
        mesh = self.mesh
        by_device: Dict[torch.device, list] = {}
        places = []  # (eval log, shard or None, device, index in its call)

        def add(dev, seg, lg, shard):
            calls = by_device.setdefault(dev, [])
            places.append((lg, shard, dev, len(calls)))
            calls.append(seg)

        for n, mems in members.items():
            lg = n + log_blowup
            if not self._shardable(n):
                f = mesh.full
                full = []
                for mem in mems:
                    rows = [f(r) for r in mem.inter_rows]
                    full.append(CompositionMember(
                        mem.component, {k: f(v) for k, v in mem.main_cols.items()}, rows,
                        rows[-4:], mem.claimed_sum, mem.alpha_offset))
                isf = f(is_first[n])
                add(mesh.home, CompositionSegment(n, full, isf,
                                                  fft.rotation_index(n, log_blowup, isf.device)),
                    lg, None)
                continue
            sh = mesh.as_sharded
            isf = sh(is_first[n])
            sharded = []
            for mem in mems:
                s_prev = self.rotate(mesh.stack(list(mem.inter_rows[-4:])), n, log_blowup)
                sharded.append((mem, {k: sh(v) for k, v in mem.main_cols.items()},
                                [sh(r) for r in mem.inter_rows], s_prev))
            for i in mesh.local:
                seg = CompositionSegment(
                    n, [CompositionMember(mem.component, {k: v.shards[i] for k, v in main.items()},
                                          [r.shards[i] for r in inter], list(s_prev.shards[i]),
                                          mem.claimed_sum, mem.alpha_offset)
                        for mem, main, inter, s_prev in sharded],
                    isf.shards[i], None, offset=i * isf.chunk)
                add(isf.shards[i].device, seg, lg, i)
        outs = {dev: composition_evaluate(segs, elements, alpha, log_blowup)
                for dev, segs in by_device.items()}
        acc: Dict[int, object] = {}
        for lg, shard, dev, k in places:
            if shard is None:
                acc[lg] = outs[dev][k]
            else:
                acc.setdefault(lg, [None] * self.D)[shard] = outs[dev][k]
        return {lg: v if isinstance(v, torch.Tensor) else Sharded(mesh, v)
                for lg, v in acc.items()}

    # -- OODS --------------------------------------------------------------

    def sample_groups(self, groups) -> torch.Tensor:
        """poly.sample_groups of groups whose rows may be Sharded: one call a
        shard (one kernel launch on a card) at its chunks' offsets, the rows
        that are not sharded in shard 0's (they are the same in every
        process, so they count once), then one mesh sum, mod p. (4, total)
        int32 on the home device, the same in every process."""
        mesh = self.mesh
        if not any(isinstance(r, Sharded) for _, _, rows in groups for r in rows):
            return poly.sample_groups([(lg, pt, [mesh.full(r) for r in rows])
                                       for lg, pt, rows in groups])

        def part(i):
            return poly.sample_groups(
                [(lg, pt, [r.shards[i] if isinstance(r, Sharded)
                           else mesh.full(r) if i == 0 else None for r in rows])
                 for lg, pt, rows in groups], shard=i).to(torch.int64)
        return (mesh.sum(mesh.each(part)) % P_INT).to(torch.int32)

    # -- Quotients ---------------------------------------------------------

    def accumulate_all(self, log_size: int, columns, groups) -> object:
        """quotients.accumulate_range on every shard's chunk of the domain
        (on a card one kernel launch a shard, at the chunk's offset)."""
        if not self._shardable(log_size):
            return quotients.accumulate_range(log_size, [self.mesh.full(c) for c in columns],
                                              groups)
        cols = [self.mesh.as_sharded(c) for c in columns]
        chunk = cols[0].chunk
        return Sharded(self.mesh, self.mesh.each(lambda i: quotients.accumulate_range(
            log_size, [c.shards[i] for c in cols], groups, offset=i * chunk)))

    # -- FRI ---------------------------------------------------------------

    def fold_step(self, values, step: fri.FoldStep, inject_a=None, inject_b=None):
        """fri.fold_step over the mesh: a chunk of the output level a shard
        (one kernel launch on a card, at the chunk's offset, from the
        matching chunks of the values and the injected inputs), until the
        output is smaller than 2 positions a shard and the step runs whole
        on the home device. int32."""
        mesh = self.mesh
        n = values.shape[1] >> step.folds
        if n < 2 * self.D:
            full = lambda x: None if x is None else mesh.full(x)  # noqa: E731
            return fri.fold_step(full(values), step, full(inject_a), full(inject_b))
        v = mesh.as_sharded(values)
        a = None if inject_a is None else mesh.as_sharded(inject_a)
        b = None if inject_b is None else mesh.as_sharded(inject_b)
        chunk = n // self.D
        return Sharded(mesh, mesh.each(lambda i: fri.fold_step(
            v.shards[i], step, None if a is None else a.shards[i],
            None if b is None else b.shards[i], offset=i * chunk)))
