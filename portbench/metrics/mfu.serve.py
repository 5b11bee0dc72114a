from portbench.readers import mfu_pct as read  # noqa: F401
