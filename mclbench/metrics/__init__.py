"""Readers of the per-layer metrics, one module a metric, named by the
metric's name with each ``.`` as ``_``.  Each has ``read(ctx)``, which
returns the metric's value from the traced window (``ctx``:
``harness.TraceContext``), or ``None`` where the window has nothing to
read; the harness then leaves the metric out of the result line."""
