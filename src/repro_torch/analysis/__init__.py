"""Analysis tools of the port: the analytic byte model (``bytes_model``),
the meta-tensor cost mode (``cost``), the collective inventory
(``collectives``) and the checks over it and over the steps (``checks``,
``check``), the schedule gates (``schedule``), the kernel cases and their
launch lint (``kernel_cases``, ``kernel_lint``), launch counts and the
docs lint."""
