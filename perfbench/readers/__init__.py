"""Readers of the per-layer metrics, one module each: ``read(ctx,
spec) -> float | None``, where ``ctx`` is ``harness.Context`` and
``spec`` the metric's file under ``metrics/``. A reader that finds
nothing to read returns None and the metric is left out of the line."""
