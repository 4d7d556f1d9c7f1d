"""The benchmark's own tests (``python -m pytest gpubench/tests``). Tests
marked ``chip`` need a CUDA card and skip without one."""


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (runs a benchmark cell on it)")
