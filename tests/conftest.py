import os

# Tests run on the CPU backend with a virtual 8-device mesh and float64
# (the multi-device path on real cards is chip_smoke.py --four-cards).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# The env assignment above only takes effect if nothing imported jax
# before this file (a plugin or a sitecustomize may have); the live config
# update pins the platform either way.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# persistent compile cache DISABLED for the suite: jaxlib 0.9 aborts
# ("Fatal Python error: Aborted" in get_executable_and_time) when
# deserializing some of this suite's executables (reproduced with a
# fresh cache directory); recompiling costs ~1 min per full run
jax.config.update("jax_compilation_cache_dir", None)


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Release compiled executables between test modules: the full suite
    compiles hundreds of programs in one process and jaxlib's CPU backend
    segfaults late in the run (reproducibly around the ~90th test, gone
    when the module runs alone) once that state accumulates."""
    yield
    jax.clear_caches()
