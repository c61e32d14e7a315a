"""Row-sharded proving step of one component over a mesh.

Counterpart of ``stwo_brainfuck_tpu/parallel/sharded.py``. Inside the step
every column is in coset LINEAR order (row r is the point q(1 + 2r)), so

- LogUp fractions and AIR constraints are pointwise: each shard computes
  its own rows;
- the LogUp prefix sum is a local cumulative sum plus the exclusive offset
  from the gathered shard totals (one all_gather);
- the claimed sum is the mod-p sum of those totals;
- S(p - g) needs only the last element of the left neighbour (one shift).

``ShardedOps.interaction`` (prove.py) uses the same fractions and prefix
sum, with the permutation to and from linear order around them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..core import qm31
from ..core.m31 import P_INT
from ..framework.component import (
    Evaluator,
    LookupElements,
    _device_elements,
    logup_fractions,
)
from .mesh import Mesh, Sharded


def shard_elements(mesh: Mesh, elements: Dict[str, LookupElements]) -> List[dict]:
    """The lookup elements' device tensors for each shard this process owns
    (one copy per device)."""
    by_dev = {dev: _device_elements(elements, dev) for dev in mesh.local_devices}
    return mesh.each(lambda i: by_dev[mesh.device(i)])


def fractions(mesh: Mesh, component, main: Dict[str, Sharded], is_first: Sharded,
              elements: Dict[str, LookupElements]):
    """LogUp fractions on every shard (logup_fractions: one kernel launch a
    shard on a card): ([per shard (K, 4, c) int32 Q_k], [per shard (4, c)
    sum of the Q_k])."""
    out = mesh.each(lambda i: logup_fractions(
        component, {k: v.shards[i] for k, v in main.items()}, is_first.shards[i], elements))
    return ([None if o is None else o[0] for o in out],
            [None if o is None else o[1] for o in out])


def prefix_sum(mesh: Mesh, shards: List[torch.Tensor]) -> Tuple[List[torch.Tensor], tuple]:
    """Inclusive prefix sum of a (4, N) QM31 array sharded in order along
    N: each shard's local cumulative sum plus the sum of the totals of the
    shards before it. Returns (per-shard (4, c) int64 sums, the claimed
    sum = the total of all shards, as a host tuple)."""
    local = mesh.each(lambda i: torch.cumsum(shards[i], dim=1, dtype=torch.int64) % P_INT)
    totals = mesh.all_gather(mesh.each(lambda i: local[i][:, -1]))   # (D, 4) per shard
    out = mesh.each(lambda i: (local[i] + totals[i][:i].sum(0)[:, None]) % P_INT)
    claimed = tuple(int(v) for v in (totals[mesh.local[0]].sum(0) % P_INT).cpu())
    return out, claimed


def sharded_prove_step(mesh: Mesh, component_cls, log_size: int):
    """(fn, component) for one component: fn(main_cols, elements, is_first)
    takes the main columns and is_first in LINEAR order ((N,) tensors or
    Sharded arrays) and the drawn lookup elements, and returns (S: the
    (4, N) prefix-sum column in linear order, Sharded; the claimed sum, a
    host tuple; the constraint values, a Sharded (n_constraints, 4, N)
    array, zero on a valid trace)."""
    comp = component_cls(log_size)

    def fn(main_cols, elements, is_first):
        main = {k: mesh.as_sharded(v) for k, v in main_cols.items()}
        isf = mesh.as_sharded(is_first)
        els = shard_elements(mesh, elements)
        q_cols, totals = fractions(mesh, comp, main, isf, elements)
        s, claimed = prefix_sum(mesh, totals)
        left = mesh.shift(s)
        cons = [None] * mesh.size
        for i in mesh.local:
            s_prev = torch.cat([left[i], s[i][:, :-1]], dim=1)
            ev = Evaluator(comp, {k: v.shards[i] for k, v in main.items()}, [*q_cols[i], s[i]],
                           s_prev, isf.shards[i], qm31.const(claimed, s[i].device),
                           els[i], host=False)
            comp.define_constraints(ev)
            cons[i] = torch.stack([c._qm(s[i]).expand(s[i].shape) for c in ev.constraints])
        return Sharded(mesh, s), claimed, Sharded(mesh, cons)

    return fn, comp
