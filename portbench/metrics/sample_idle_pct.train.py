def read(trace):
    """Share of the window in which the device is idle and the host is in
    the program's sampler."""
    idle = getattr(trace, "program_idle_s", lambda names: None)(
        ["sampler.sample"])
    return 100.0 * idle / trace.window_s if idle is not None else None
