"""Engine time of one sweep, in ms: the engine's spans over the window
less the archive's spans inside them, divided by the sweeps they ran."""


def read(reading):
    calls = [c for c in reading.get("calls", [])
             if "bench.engine" in c.get("spans", {})]
    sweeps = sum(c["sweeps"] for c in calls)
    if not sweeps:
        return None
    return 1e3 * sum(c["spans"]["bench.engine"]
                     - c["spans"].get("bench.archive", 0.0)
                     for c in calls) / sweeps
