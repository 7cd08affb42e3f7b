"""Root pytest config.

- registers the ``slow`` marker (also declared in pyproject.toml, but
  kept here so ad-hoc invocations without ini discovery stay
  warning-free);
- degrades optional-dependency suites to *skips* instead of
  collection errors: ``tests/test_property.py`` needs ``hypothesis``,
  which the minimal runtime image does not ship.
"""

import importlib.util

collect_ignore = []
if importlib.util.find_spec("hypothesis") is None:
    collect_ignore.append("tests/test_property.py")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running end-to-end test (subprocess meshes, "
        "training loops)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the PyTorch port's hand-written "
        "kernels); skips without one")
