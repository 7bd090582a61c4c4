"""Stable sort of non-negative int32 keys (the schedule compiler's
composite-key sort and the ``gather_agg`` backward's by-source sort)."""
