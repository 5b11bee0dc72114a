from portbench.readers import launches_per_step as read  # noqa: F401
