"""Device ms a step of the kernels the host launched inside the program's
``reinforce.rollout`` span (matched by the launches' correlation ids)."""


def read(run):
    if run.trace is None or "reinforce.rollout" not in run.trace.span_device_s:
        return None
    return run.trace.span_device_s["reinforce.rollout"] / run.trace.steps * 1e3
