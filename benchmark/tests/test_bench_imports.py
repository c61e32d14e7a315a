"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port. Module names are compared by their
top-level part as a whole word: the port's name begins with the JAX
package's."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import harness

BENCH = Path(harness.BENCH_DIR)
FORBIDDEN = {"jax", "jaxlib", "flax", "stwo_brainfuck_tpu"}
PORT = "stwo_brainfuck_tpu_torch"


def _top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = FORBIDDEN & set(_top_imports(path))
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        tops = set(_top_imports(path))
        assert PORT not in tops and not (FORBIDDEN & tops), path


def test_the_whole_word_rule():
    saved = dict(sys.modules)
    try:
        sys.modules["stwo_brainfuck_tpu_torch_fake.x"] = sys
        assert harness.forbidden_modules() == [m for m in harness.forbidden_modules()
                                               if not m.startswith("stwo_brainfuck_tpu_torch")]
        sys.modules["stwo_brainfuck_tpu.fake"] = sys
        assert "stwo_brainfuck_tpu.fake" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_process_that_proves_and_judges_holds_none():
    """What a run loads in its process: the harness, every metric reader,
    the reference, and a prove on the CPU."""
    code = f"""
import sys
sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}]
import harness, control
from reference import check
for name in harness.list_names()["metrics"]:
    harness.metric_reader(name)
cell = harness.Cell("t", dict(log_blowup=1, n_queries=8, pow_bits=4, log_max_rows=0),
                    __import__("traffic").Traffic("t", (__import__("traffic").Entry("t", "+>,.", bytes([1]), 4, 2),)),
                    {{}}, [], [])
harness.prove_request(cell, *cell.traffic.request(1, 0), "cpu")
print("held:" + ",".join(harness.forbidden_modules()))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "held:"
