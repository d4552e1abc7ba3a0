import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "oracle: needs the reference build")
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU as JAX's default device (skips "
        "elsewhere); run with `pytest tests/ -m gpu -p no:xdist`")


@pytest.fixture(scope="session")
def oracle_mod():
    import oracle

    if not oracle.available():
        pytest.skip("reference oracle build not available")
    return oracle


@pytest.fixture
def gpu_device():
    """JAX's default device, when it is a GPU; skips the test otherwise.
    Decided here, at run time, so every worker collects the same tests."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev
