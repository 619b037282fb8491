"""Set-up: process start to the first timed request (imports, the CUDA
context, the port's kernel library, plan builds, warm-up requests)."""


def read(w):
    return w.setup_s
