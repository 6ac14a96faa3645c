"""Set-up: seconds from the start of the process to the first timed phase
(imports, the inputs, the program's operator and tables, the warm-up
phases, and in a run that builds them the CUDA libraries)."""


def read(ctx):
    return ctx["setup_s"]
