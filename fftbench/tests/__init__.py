"""CPU tests of the benchmark harness (``python -m pytest fftbench/tests``)."""
