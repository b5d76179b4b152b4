"""Device ms a step of the kernels the host launched inside the program's
``reinforce.backward`` span (matched by the launches' correlation ids)."""


def read(run):
    if run.trace is None or "reinforce.backward" not in run.trace.span_device_s:
        return None
    return run.trace.span_device_s["reinforce.backward"] / run.trace.steps * 1e3
