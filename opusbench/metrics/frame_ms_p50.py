"""frame_ms_p50: the 50th percentile, over every tick of the window, of
the ms from the tick's due time to the return of its serve() call."""

from opusbench.readers import percentile_ms


def read(run):
    return percentile_ms(run, 50)
