"""``launches_per_request.serve``: every kernel launch in the traced window
over the requests in it.
"""

MODE = "serve"


def read(run):
    return run.launches_per_unit()
