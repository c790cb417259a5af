# Release / CI procedure (the default quick tier alone must
# not be the only regression guard — the heavy tier carries the CLI,
# committed-golden/fidelity and multihost tests).
#
#   make test        both tiers, the full certification run
#   make test-quick  default tier (pyproject addopts: -m 'not heavy')
#   make test-heavy  heavy tier only
#   make bench       the perf bench on the attached GPU
#   make chip-smoke  main path, goldens and full-width check on the GPU

.PHONY: test test-quick test-heavy bench chip-smoke

test: test-quick test-heavy

test-quick:
	python -m pytest tests/ -q

test-heavy:
	python -m pytest tests/ -q -m heavy

bench:
	python bench.py

chip-smoke:
	python chip_smoke.py
