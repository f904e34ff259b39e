"""`device_idle_pct.<cells>`: share of the profiled steps' wall time in
which no operation ran on the device, in percent; None where nothing was
profiled."""


def read(obs: dict):
    tr = obs.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
