"""frame_ms_p95.music_live: the 95th percentile, over every tick of the
window, of the ms from the tick's due time to the return of its serve()
call, in the live music cell.  The same quantity as frame_ms_p95, read
per layer there: its runs spread too widely on the host's clock to hold
it to a bound end to end."""

from opusbench.readers import percentile_ms


def read(run):
    return percentile_ms(run, 95)
