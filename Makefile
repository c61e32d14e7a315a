# One-command gate mirroring the reference's CI (.github/workflows/ci.yaml):
# unit + integration tests on CPU (8 virtual devices exercise the sharding
# paths), byte-compile lint, the multi-chip dry-run, and optional ruff.

PY ?= python

.PHONY: check test lint dryrun bench

check: lint test dryrun

test:
	$(PY) -m pytest tests/ -q

lint:
	$(PY) -m compileall -q stwo_brainfuck_tpu stwo_brainfuck_tpu_torch tests bench.py __graft_entry__.py chip_smoke.py
	@if $(PY) -c "import ruff" 2>/dev/null || command -v ruff >/dev/null 2>&1; then \
		ruff check stwo_brainfuck_tpu stwo_brainfuck_tpu_torch tests bench.py __graft_entry__.py chip_smoke.py; \
	else \
		echo "ruff not installed - skipped (config in pyproject.toml)"; \
	fi

dryrun:
	JAX_PLATFORMS=cpu XLA_FLAGS="--xla_force_host_platform_device_count=8" \
	$(PY) -c "import __graft_entry__ as g; g.dryrun_multichip(8); print('dryrun ok')"

bench:
	$(PY) bench.py
