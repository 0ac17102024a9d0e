"""Milliseconds a query of the program's ``device_dp`` span (launches,
syncs, copies back, the host end extraction between K7 and K8, the
walks), a ``stage`` of ``spaln_tpu_torch.utils.metrics``, summed over
the window, in an ``align`` cell of a traced run."""


def read(run):
    t = run["trace"]
    if run["entry"] != "align" or t is None or "device_dp" not in t["stage_s"]:
        return None
    return 1e3 * t["stage_s"]["device_dp"] / run["n"]
