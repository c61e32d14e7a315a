"""The frozen arithmetic on recorded inputs: the busy union, the quotient
bytes bound from a layout, and the phase marker's ranges."""

import torch

import harness
from arith import busy_union, quotient_bytes
from traffic import Entry, Traffic

# the small program's claim, as its proofs record it
SMALL_CLAIM = {"memory": 8, "instruction": 8, "program": 6, "processor": 6,
               "jump_if_not_zero": 4, "jump_if_zero": 4, "plus_instruction": 4,
               "minus_instruction": 4, "left_instruction": 4, "right_instruction": 4,
               "input_instruction": 4, "output_instruction": 4, "end_of_execution": 4}


def test_busy_union_merges_overlaps_and_keeps_gaps():
    busy, gaps = busy_union([(5, 7), (0, 2), (1, 3), (3, 4), (10, 11)])
    assert busy == 7 and gaps == [(4, 5), (7, 10)]
    assert busy_union([]) == (0.0, [])


def test_quotient_bytes_of_the_small_claim():
    # every opened column read once at its size (trace log + blowup): the
    # is_first column of each used size, each component's trace columns, its
    # interaction columns; the composition's 4 at max log + 2 blowups; 16 B
    # written a point of each size
    cfg = {"log_blowup": 1, "n_queries": 20, "pow_bits": 10, "log_max_rows": 0}
    from reference.verify import PcsConfig, layout

    _comps, trees = layout(SMALL_CLAIM, PcsConfig(**cfg))
    by_size = {}
    for metas in trees:
        for m in metas:
            if m.shifts:
                by_size[m.log_size + 1] = by_size.get(m.log_size + 1, 0) + 1
    want = sum(4 * n * 2**s + 16 * 2**s for s, n in by_size.items())
    assert quotient_bytes(SMALL_CLAIM, cfg) == want
    assert sorted(by_size) == [5, 7, 9, 10]  # 4+1, 6+1, 8+1 and the composition at 8+1+1
    assert by_size[10] == 4


def test_phase_marks_name_every_prove_phase():
    from stwo_brainfuck_tpu_torch.air import PHASES
    from torch.profiler import ProfilerActivity, profile

    cell = harness.Cell("t", dict(log_blowup=1, n_queries=8, pow_bits=4, log_max_rows=0),
                        Traffic("t", (Entry("t", "+>,.", bytes([1]), 4, 2),)), {}, [], [])
    marks = harness.PhaseMarks(cuda=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.request.0"):
            marks.start()
            harness.prove_request(cell, *cell.traffic.request(1, 0), "cpu", marks)
            marks.stop()
    td = harness.read_trace(prof, marks, 1.0, 1)
    assert list(marks.names.values()) == list(PHASES) + ["return"]
    assert set(td.phase_s) == set(PHASES) | {"return"}
    assert td.busy_s == 0 and td.kernel_s == {}
