# Developer entry points (build infra parity with the reference's PGXS
# Makefile + format.sh; the "extension" here is the Python package + the
# native IO library).

.PHONY: test native bench bench-small clean multichip-dryrun

test:
	python -m pytest tests/ -x -q

native:
	$(MAKE) -C native

bench:
	python bench.py

bench-small:
	BENCH_SMALL=1 python bench.py

multichip-dryrun:
	XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
	python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"

clean:
	$(MAKE) -C native clean
	rm -rf .pytest_cache postgres_word2vec/__pycache__
