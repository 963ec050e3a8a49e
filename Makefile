# Developer entry points (see README.md / CLAUDE.md)

.PHONY: test test-chip chip-smoke bench validate golden-regen lint

test:
	python -m pytest tests/ -q

test-chip:
	JAX_PLATFORMS=cuda python -m pytest tests/ -q -m chip

chip-smoke:
	python chip_smoke.py

bench:
	python bench.py

validate:
	python validate.py

golden-regen:
	GOLDEN_REGEN=1 python -m pytest tests/test_golden.py -q

lint:
	python -m compileall -q gppvae_tpu tests bench.py validate.py __graft_entry__.py chip_smoke.py
