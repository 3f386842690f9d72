"""``setup_s`` (s, host clock): from the process's start to the end of the
warm-up solve: imports, the kernels' load (their build in a checkout's
first run), the inputs, the program's stores and one solve."""


def read(run):
    return run.setup_s
