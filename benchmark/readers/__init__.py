"""Per-layer metric readers: one module a source kind, found by the metric
file's ``reader``."""
