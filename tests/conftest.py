"""Test harness config: JAX on the CPU with 8 virtual devices.

Multi-device logic is tested without hardware on virtual CPU devices.  Both
settings below are defaults, read when JAX first creates its backends: a
process that already runs on the GPU (chip_smoke.py runs the `gpu`-marked
tests in its own process) keeps its devices.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

# Persistent XLA compile cache: the suite's dominant cost is XLA-CPU
# compilation of the jitted render programs, re-paid every run AND after
# every inter-module jax.clear_caches (below).  The cache (utils/cache.py)
# turns those recompiles into disk hits across runs and xdist workers.
from raytracer_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless this process runs on an NVIDIA GPU.

    Decided per test, never at import: every xdist worker must collect
    the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run through `python chip_smoke.py`")
    return jax.devices()[0]


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches_between_modules():
    """Bound accumulated XLA-CPU compile state.

    A single pytest process running the whole suite used to SIGSEGV inside
    XLA's backend_compile_and_load around the 70th test (always AFTER the
    8-virtual-device test_parallel programs) — every test passes when run
    in smaller batches, so the crash is an accumulation effect, not a test
    bug.  Two mitigations ship: jitted-program caches are dropped between
    test modules (this fixture), and the suite defaults to xdist worker
    processes (pyproject.toml addopts)."""
    yield
    jax.clear_caches()
    import gc

    gc.collect()
