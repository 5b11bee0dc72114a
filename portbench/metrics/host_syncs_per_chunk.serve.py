def read(trace):
    """The program's host waits in the window, over its chunks."""
    syncs = getattr(trace, "host_syncs", lambda: None)()
    return syncs / trace.steps if syncs is not None and trace.steps else None
