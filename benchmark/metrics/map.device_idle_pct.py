"""The window's share in which no operation runs on the device: the
window minus the union of the intervals of every device operation the
profiler recorded (the run's ``busy_s``), over the window, in %, in
a ``map`` cell of a traced run."""


def read(run):
    t = run["trace"]
    if run["entry"] != "map" or t is None:
        return None
    return 100.0 * (1 - t["busy_s"] / t["window_s"])
