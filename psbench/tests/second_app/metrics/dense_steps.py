"""Steps the dense model ran in the window."""


def read(ctx):
    return ctx.get("dense_steps")
