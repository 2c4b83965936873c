"""index_build_s: wall seconds of the ``Mapper``'s construction, the
genome's copy and the index built on the card, synchronised before and
after."""


def read(ctx):
    return ctx["index_build_s"]
