"""Device ms a step of the packed lanes' copy to pinned host memory
(``runtime/handoff.DeviceBatch``), from the trace's device-to-host copies."""


def read(ctx):
    if ctx.trace is None or not ctx.traced["steps"]:
        return None
    t = ctx.trace.device_time(r"DtoH", cats=("gpu_memcpy",))
    return 1e3 * t / ctx.traced["steps"] if t > 0 else None
