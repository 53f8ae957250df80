"""Analysis tools of the port: the analytic byte model (``bytes_model``)."""
