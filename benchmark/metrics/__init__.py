"""Per-layer metric readers, one file a metric, found by the metric's name
(``metrics/<name>.py``, each with ``read(trace) -> float | None``), and the
arithmetic they share (the modules whose names start with ``_``)."""
