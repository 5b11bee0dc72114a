def read(trace):
    """Share of the window in which the device is idle and the host is in
    the program's memory pull or write-back."""
    idle = getattr(trace, "program_idle_s", lambda names: None)(
        ["memory.pull", "memory.write_back"])
    return 100.0 * idle / trace.window_s if idle is not None else None
