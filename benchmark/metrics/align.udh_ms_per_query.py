"""Milliseconds a query of the program's ``udh`` span (each batch of the
linear-space UDH path: the links pass, the backwalk, the retrace and its
strip walks, inside ``device_dp``), a ``stage`` of
``spaln_tpu_torch.utils.metrics``, summed over the window, in an
``align`` cell of a traced run."""


def read(run):
    t = run["trace"]
    if run["entry"] != "align" or t is None or "udh" not in t["stage_s"]:
        return None
    return 1e3 * t["stage_s"]["udh"] / run["n"]
