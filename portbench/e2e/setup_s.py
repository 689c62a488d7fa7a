"""Set-up: from the process's start to the window's, with everything the
run loads, builds, makes and warms up in between."""


def read(run):
    return run.setup_s
