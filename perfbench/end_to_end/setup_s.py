"""Set-up seconds: from the process's start to the first step of the
window."""


def read(run):
    return run.setup_s
