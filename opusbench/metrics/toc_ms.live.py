"""toc_ms.live: host ms a step of the mixed decoder's ToC parse, which
sorts every packet by mode, bandwidth and channels before plane A."""

WRAPS = ("_toc_arrays",)


def read(run):
    return run.span_ms(WRAPS[0])
