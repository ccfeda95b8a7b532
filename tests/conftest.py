"""Test configuration.

Mirrors the reference's 'JLArrays tier' (test/runtests.jl:21 — a fake GPU
backend in default CI): we run the suite on the CPU backend with x64 enabled
and a virtual 8-device mesh (XLA host-platform device count) so multi-device
sharding is validated without an accelerator (SURVEY.md §4). The GPU runs
go through chip_smoke.py and bench.py.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_ENABLE_X64", "true")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

# repo root on sys.path so `import linops_tpu` works from tests/
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# jax config beats the env var if anything set it: tests are the
# CPU/virtual-mesh tier.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)
