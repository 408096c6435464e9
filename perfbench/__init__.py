"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
result line.  Everything that belongs to one configuration, traffic mix,
cell or metric is a file of its own that the harness finds by name:

* ``configs/<config>.json``: the model configuration as published, with
  ``source``, ``reduced``, ``assumed``, ``deployment``, ``departures`` and
  the port-only settings under ``port``;
* ``traffic/<traffic>.json``: the parameters the one generator
  (``traffic/generator.py``) reads;
* ``workloads/<cell>.json``: the cell's configuration, traffic, engine
  settings and correctness limits;
* ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one reader a
  metric, ``read(ctx)`` returning a number or None (a metric split by
  cells, ``<metric>.<cells>``, may share ``<metric>.py``).

The plain float32 reference lives in ``reference/`` and imports nothing of
the port; ``work/`` counts operations and bytes from shapes and data.
"""
