"""pytest's configuration above the harness's tests: the test size of
each configuration that the table of ``tests/conftest.py`` (``TINY``,
fixed when the harness was written) does not hold, added to that table
when pytest registers it, so that a checkout root made for the tests
cuts every configuration of ``BENCHMARK.json``."""

#: configurations added since, at test size (kron at scale 9)
TINY = {"chl_kron22": {"scale": 9, "n": 512}}


def pytest_plugin_registered(plugin):
    table = getattr(plugin, "TINY", None)
    if isinstance(table, dict) and table is not TINY:
        for name, sizes in TINY.items():
            table.setdefault(name, sizes)
