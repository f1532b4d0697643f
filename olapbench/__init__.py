"""The port's benchmark: star-schema SQL served over HTTP to closed-loop clients.

Run one cell from the root of a checkout::

    python3 olapbench/run.py --workload ssb_sf1.dashboard --seed 7 \
        --seconds 51 --trace 0

Every configuration, traffic mix, statement template and per-layer metric
is a file of its own under this directory, found by the name that
``BENCHMARK.json`` gives it (``catalog.py``).

Its tests run on the CPU at tiny scales (``python -m pytest
olapbench/tests``); the one marked ``card`` runs on a machine with a
CUDA device (``python -m pytest olapbench/tests -m card``). The
correctness control: ``python3 olapbench/control.py``.
"""
