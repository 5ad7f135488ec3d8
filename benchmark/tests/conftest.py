"""The benchmark's tests run on the CPU at small widths; tests marked
``cuda`` need a card and skip without one (decided inside the test)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skipped without a card")
