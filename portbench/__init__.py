"""The benchmark of ``repro_torch`` on NVIDIA H100 cards.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell: it builds the system under test from the
cell's files, warms it up, measures it for ``--seconds``, checks what the
timed path produced against the plain reference in ``reference/`` and
prints one JSON line. Cells (``workloads/``), configurations
(``configs/``), drivers (``drivers/``) and per-layer metrics
(``metrics/``) are found by name, so each is added as new files.
"""
