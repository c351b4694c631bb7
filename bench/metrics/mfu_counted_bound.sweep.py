"""Share of the chip's peak that a whole sweep reaches, in %: the sweep's
least time by the cell's frozen work counts (its least bytes at 3.35 TB/s
against its counted float64 operations at 34 TFLOP/s) over the measured
engine time of a sweep (``sweep_ms``)."""
from bench.harness.work import sweep_bound_s


def read(reading):
    calls = [c for c in reading.get("calls", [])
             if "bench.engine" in c.get("spans", {})]
    sweeps = sum(c["sweeps"] for c in calls)
    engine_s = sum(c["spans"]["bench.engine"]
                   - c["spans"].get("bench.archive", 0.0) for c in calls)
    if not sweeps or engine_s <= 0 or not reading.get("bound"):
        return None
    least = sweep_bound_s(reading["work"], calls[0]["rows"],
                          reading["width"], reading["bound"]["entry_bytes"])
    if least is None:
        return None
    return 100.0 * least / (engine_s / sweeps)
