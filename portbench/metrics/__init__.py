"""Per-layer metric readers, one file each, found by the metric's name.

``BENCHMARK.json``'s per-layer metric ``<name>`` is read by
``metrics/<name>.py`` or, where that file is missing, by the file of the
part of the name before the first dot (``megastep_ms.act`` and
``megastep_ms.train`` share ``megastep_ms.py``). Each file defines
``read(ctx) -> float | None`` over a :class:`portbench.bench.ReaderContext`;
``None`` means there was nothing to read, and the metric is left out of
the result line.
"""
