"""setup_s: seconds from the start of the run to the end of its warm-up
(torch and the card, the cell's files, pools and schedule, the decoder,
building, and two periods of traffic served)."""


def read(run):
    return run.setup_s
