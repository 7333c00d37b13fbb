"""HTTP front end (``server/http.py``, ``server/eventloop.py``): the
mean client latency of the traced window's answers less the mean time
inside ``API.query``, from the timer the benchmark wraps around it."""


def read(run):
    lat = [(r[3] - r[2]) * 1e3 for r in run.answered()]
    if not lat or not run.api_seconds:
        return None
    return sum(lat) / len(lat) - sum(run.api_seconds) / len(run.api_seconds) * 1e3
