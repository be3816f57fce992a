"""device.exposed_wait_ms_per_protein: the seconds the pump waited on
the card at each collect wave's join (the profiler's
``device_exposed_s``), in ms a protein mapped."""


def read(ctx):
    s = ctx["device_exposed_s"]
    return None if s is None else 1e3 * s / ctx["proteins"]
