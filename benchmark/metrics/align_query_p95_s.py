"""95th percentile of one query's time in the ``align`` entry, call to the
end of its output, over every query of the window (host clock)."""
import numpy as np


def read(run):
    if run["entry"] != "align" or not run["query_s"]:
        return None
    return float(np.percentile(run["query_s"], 95))
