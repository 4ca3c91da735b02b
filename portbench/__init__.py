"""The benchmark of tahoe_tpu_torch, the PyTorch and CUDA port.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card it is
started on and prints one JSON result line. Everything that belongs to one
configuration, traffic mix or metric is a file of its own, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose ``kind`` names
the load that drives it, ``kinds/<kind>.py``) and ``metrics/<metric>.py``. The yardstick (the generators, the plain
reference, the counting of work and the peaks, the reading of the trace and
the comparison that decides ``correct``) lives here and imports nothing of
the port but the entry it times.
"""
