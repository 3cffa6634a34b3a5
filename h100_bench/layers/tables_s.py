"""Genome tables (``ops/subst_tables.build_subst_tables``): seconds of the
build and upload in set-up, ending in a synchronise."""


def read(ctx):
    return ctx.setup.get("tables_s")
