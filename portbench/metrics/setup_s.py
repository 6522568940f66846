"""Set-up: from the process's start to the window's (imports, kernel load
or build, inputs made on the device, warm-up of the cell's shapes)."""


def read(ctx):
    return ctx.setup_s
