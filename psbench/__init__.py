"""The port's benchmark: ``run.py`` runs one cell of ``BENCHMARK.json``.

Found by name: ``configs/<config>.json`` (a configuration's sizes),
``workloads/<cell>.json`` (the driver, the traffic's parameters, the trace
stretch and the limits of ``correct``), ``drivers/<driver>.py`` (one entry
path of the program), ``layer_metrics/<metric>.py`` (one reader a per-layer
metric); ``traffic.py`` makes inputs from the seed, ``roofline.py`` holds
the peaks and the counts, ``reference/`` the plain references,
``compare.py`` the comparison, ``control.py`` the readings that set the
limits.  Tests: ``python -m pytest psbench/tests`` (those needing a card
skip without one).
"""
