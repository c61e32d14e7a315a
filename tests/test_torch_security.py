"""The port's security-parameter floors pinned to docs/SECURITY.md (the
soundness budget) and to the JAX package's: the floor the verifier accepts
(air.MIN_SECURITY_CONFIG), PcsConfig()'s defaults and the row cap. The JAX
package's root-cache tests have no counterpart: the port keeps no disk
cache of preprocessed roots, it recomputes the root in process."""

import os
import re

import pytest

from stwo_brainfuck_tpu import air as jair
from stwo_brainfuck_tpu.core.pcs import PcsConfig as JPcsConfig
from stwo_brainfuck_tpu_torch import air
from stwo_brainfuck_tpu_torch.core.pcs import PcsConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _documented() -> dict:
    """name -> (default, floor) from the parameter table of
    docs/SECURITY.md (rows like "| `n_queries` q | 20 | ≥ 8 | ...")."""
    with open(os.path.join(ROOT, "docs", "SECURITY.md")) as f:
        rows = re.findall(r"^\| `(\w+)`[^|]*\| (\d+) \| ≥ (\d+) \|", f.read(), re.M)
    return {name: (int(default), int(floor)) for name, default, floor in rows}


def test_security_floors_pinned_to_documented_values():
    """docs/SECURITY.md derives these floors; changing them requires
    re-deriving the soundness budget there."""
    floor = air.MIN_SECURITY_CONFIG
    assert (floor.log_blowup, floor.n_queries, floor.pow_bits) == (1, 8, 4)
    default = PcsConfig()
    assert (default.log_blowup, default.n_queries, default.pow_bits) == (1, 20, 10)
    assert air.LOG_MAX_ROWS_CAP == 24  # reference LOG_MAX_ROWS parity
    assert floor.to_json() == jair.MIN_SECURITY_CONFIG.to_json()
    assert default.to_json() == JPcsConfig().to_json()
    assert air.LOG_MAX_ROWS_CAP == jair.LOG_MAX_ROWS_CAP


@pytest.mark.parametrize("name", ["log_blowup", "n_queries", "pow_bits"])
def test_security_table_row_matches_the_port(name):
    default, floor = _documented()[name]
    assert getattr(PcsConfig(), name) == default
    assert getattr(air.MIN_SECURITY_CONFIG, name) == floor
