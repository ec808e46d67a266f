"""audio_s_per_s: audio-seconds decoded in the window (streams x 20 ms a
step, every step of every call) over the window's seconds."""


def read(run):
    return run.window["audio_s"] / run.window["window_s"]
