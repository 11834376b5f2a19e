"""host_step_ms.train: the host clock's time for one step call (upload, G
step, pool query, D step) to return, averaged over the window's steps: how
far the host holds the step."""


def read(data):
    host = data.get("host_step_s")
    if not host:
        return None
    return 1000.0 * sum(host) / len(host)
