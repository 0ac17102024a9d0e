"""Process start to the first timed query (host clock): imports, the
deployment and index from the checkout's cache (built there on a first
run), the system's set-up, the kernels' build or load, the warm-up."""


def read(run):
    return run["setup_s"]
