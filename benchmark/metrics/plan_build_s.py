"""plan_build_s: seconds of the port's ``from_coo`` on the run's triplets,
to its device plan synchronised (host clock)."""


def read(ctx):
    return ctx.spans.get("from_coo")
