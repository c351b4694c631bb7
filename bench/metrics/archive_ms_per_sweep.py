"""Frontier archive time a sweep, in ms: the spans of
``ParetoArchive.insert`` over the window, divided by the sweeps whose
designs they took in."""


def read(reading):
    calls = [c for c in reading.get("calls", [])
             if "bench.archive" in c.get("spans", {})]
    sweeps = sum(c["sweeps"] for c in calls)
    if not sweeps:
        return None
    return 1e3 * sum(c["spans"]["bench.archive"] for c in calls) / sweeps
