# Convenience entry points (the framework itself needs no build step;
# `make native` compiles the optional C++ host kernels).

.PHONY: test test-all bench goldens goldens-dryrun native

test:
	python -m pytest tests/ -x -q -m "not slow"

test-all:
	python -m pytest tests/ -q

bench:
	python bench.py

native:
	python -c "from ligero_jax import native; assert native.available(), 'g++ build failed'; print('native kernels ok')"

# One-shot golden capture against the Rust reference (needs a Rust
# toolchain + network; see tools/capture_goldens/README.md).  REF
# defaults to the read-only reference checkout.
REF ?= /root/reference
goldens:
	bash tools/capture_goldens/capture.sh $(REF)

# Validates the kit without Rust (file inventory, patch application,
# harness-vs-test filename contract, cargo metadata when available).
goldens-dryrun:
	bash tools/capture_goldens/dryrun.sh $(REF)
