"""Test harness: an 8-virtual-device CPU JAX platform.

SURVEY.md §5 "multi-device without a cluster": all sharding/collective
tests run against 8 virtual CPU devices, so the suite needs no
accelerator. `jax.config.update` applies before the first backend use, so
it wins over whatever platform the environment names.

Tests marked `gpu` need the card: they skip here. `chip_smoke.py` runs them
in its own process, whose backend is already up on the GPU; the platform
is then left as it is.
"""

import jax
import pytest
from jax._src import xla_bridge

from parakeet_slam_tpu.utils.compile_cache import enable_compile_cache

if not xla_bridge.backends_are_initialized():
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", False)
    enable_compile_cache()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none. Decided
    here at run time, never at import or collection."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU (run on the card by chip_smoke.py)")
    return devices[0]
