"""The benchmark's own tests: on the CPU, at a size a test run holds.

    python3 -m pytest bench_torch/tests -q -p no:cacheprovider
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
