"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

``python3 bench_port/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see README.md.
Importing the package puts the checkout's ``src/`` on ``sys.path`` so the
port is importable as ``repro_torch``.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(ROOT, "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
