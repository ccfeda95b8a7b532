# CI tier definition (reference: .github/workflows/CI.yml runs the Julia
# suite across a version/OS matrix; here the contract is pinned as make
# targets the driver and any CI can invoke).

PY ?= python

# Full correctness tier: CPU backend, x64, virtual 8-device mesh
# (tests/conftest.py sets the platform/x64; the XLA flag provides devices).
test:
	XLA_FLAGS="--xla_force_host_platform_device_count=8" \
		$(PY) -m pytest tests/ -q

# Fast smoke tier (core semantics only).
test-fast:
	XLA_FLAGS="--xla_force_host_platform_device_count=8" \
		$(PY) -m pytest tests/test_linop.py tests/test_contract_sweep.py -q

# Multi-chip compile/execute validation on the virtual mesh.
multichip:
	XLA_FLAGS="--xla_force_host_platform_device_count=8" JAX_PLATFORMS=cpu \
		$(PY) __graft_entry__.py --multichip

# Multi-device scaling harness (virtual mesh; prints one JSON line).
scaling:
	XLA_FLAGS="--xla_force_host_platform_device_count=8" JAX_PLATFORMS=cpu \
		$(PY) -m linops_tpu.parallel.scaling_bench

# One-GPU smoke test of the main paths against NumPy/scipy references.
smoke:
	$(PY) chip_smoke.py

# Single-GPU perf bench.
bench:
	$(PY) bench.py

.PHONY: test test-fast multichip scaling smoke bench
