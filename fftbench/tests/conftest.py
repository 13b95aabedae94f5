"""The harness's tests run on the host with the port's plain versions;
a test that needs a card is marked ``card`` and skips inside itself where
there is none."""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault("REGENT_FFT_NO_WISDOM", "1")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "card: needs a CUDA card; skips inside the test without one")
