"""Host milliseconds a training step: the harness's clock around the
step's call until it returns; the mean over the window."""


def read(run):
    host = run.state.get("host")
    if not host:
        return None
    return sum(host) / len(host) * 1e3
