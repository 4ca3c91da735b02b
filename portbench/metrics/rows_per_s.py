from portbench.readers import rows_per_s as read  # noqa: F401
