def read(trace):
    """Megabytes the store's view refreshes uploaded in the window, over
    its chunks."""
    if not getattr(trace, "program_spans", None) or not trace.steps:
        return None
    return trace.counters.get("store.view_bytes", 0) / 1e6 / trace.steps
