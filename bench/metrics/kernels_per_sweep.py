"""Device operations of one sweep: those in the profiled window divided
by the sweeps it covers."""


def read(reading):
    tr = reading["trace"]
    if not tr or not tr["periods"] or not tr["n_device_ops"]:
        return None
    return tr["n_device_ops"] / tr["periods"]
