"""The port's own record of its spans and counters
(``rtgs_tpu_torch.utils.profiling.read``), filled while a profiler recorded
the traced stretches. The metric's spec is ``{"span": name, "clock":
"host" | "stream", "per": top span}`` (a span's total host or stream ms) or
``{"counter": name, "per": top span}`` (a counter's total); either is
divided by the number of ``per`` spans recorded (one a frame or step of
every stretch the profiler recorded). Nothing where the port keeps no
record, or where the span, its clock or the counter never ran."""

from rtgs_tpu_torch.utils import profiling


def read(spec: dict, ctx):
    reading = getattr(profiling, "read", None)
    if reading is None:
        return None
    rec = reading()
    per = rec["spans"].get(spec["per"], {}).get("count", 0)
    if not per:
        return None
    if "counter" in spec:
        total = rec["counters"].get(spec["counter"])
    else:
        total = rec["spans"].get(spec["span"], {}).get(
            "host_ms" if spec["clock"] == "host" else "stream_ms")
    return None if total is None else total / per
