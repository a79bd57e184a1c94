"""The benchmark of ``rad_tpu_torch`` on one NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything that
belongs to one configuration, traffic mix or metric is a file of its own,
found by its name: ``configs/<config>.json``, ``workloads/<traffic>.json``
(whose ``driver`` names ``drivers/<driver>.py``) and
``metrics/<metric>.py``. The reference that decides ``correct`` lives in
``reference/`` and imports nothing of the program.
"""
