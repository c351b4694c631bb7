"""Designs evaluated a second, in evals/s: the evaluations of every call
completed in the window (a search's seed population and its proposals)
over the time from the window's start to the last call's end."""


def read(reading):
    if not reading.get("calls") or reading["window_s"] <= 0:
        return None
    return reading["evaluations"] / reading["window_s"]
