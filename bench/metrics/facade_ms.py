"""Facade and strategy time of a search call, in ms: the call's span less
the engine's span inside it (the host's seeding of the population, the
result's assembly), averaged over the window's calls."""


def read(reading):
    calls = [c for c in reading.get("calls", [])
             if "bench.engine" in c.get("spans", {})]
    if not calls:
        return None
    return 1e3 * sum(c["call_s"] - c["spans"]["bench.engine"]
                     for c in calls) / len(calls)
