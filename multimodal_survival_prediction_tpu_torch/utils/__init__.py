"""Small helpers shared across the port."""


def parse_hu_window(s):
    """CLI 'lo,hi' -> (lo, hi) floats; None/'' -> None (the port's copy of
    ``multimodal_survival_prediction_tpu/utils/__init__.py:parse_hu_window``).

    Single source of truth for every entry point's --hu-window flag (the
    value must match between training ingest and any later scoring)."""
    return tuple(float(x) for x in s.split(",")) if s else None
