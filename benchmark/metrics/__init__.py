"""One reader a metric, found by the metric's name in ``BENCHMARK.json``.

Each module ``<name>.py`` defines ``read(ctx)``, which returns the metric's
value or ``None`` where the run holds nothing for it to read. ``ctx`` is a
:class:`benchmark.harness.Context`.
"""
