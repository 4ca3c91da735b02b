from portbench.readers import predict_roofline_pct as read  # noqa: F401
