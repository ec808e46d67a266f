"""Soft clipping of float PCM, a copy of opus_tpu.softclip.

The scalar Decoder runs it on the int16 output path.

Below this docstring the code is the reference's, unchanged
(tests/test_torch_library.py holds the two equal).
"""

from __future__ import annotations

import numpy as np


def pcm_soft_clip(pcm: np.ndarray, channels: int, softclip_mem: np.ndarray) -> None:
    """Softly clip interleaved float PCM into [-1, 1], in place.

    ``softclip_mem`` carries one nonlinearity coefficient per channel across
    calls so consecutive frames join without derivative discontinuities.
    """
    if pcm.size == 0 or channels <= 0 or softclip_mem.shape[0] < channels:
        return
    frame_size = pcm.size // channels

    # The nonlinearity x + a*x^2 is only monotonic up to |x| = 2; saturate
    # there first (derivative is zero at that point, so no discontinuity).
    np.clip(pcm, -2.0, 2.0, out=pcm)

    for c in range(channels):
        a = softclip_mem[c]

        # Finish applying the previous frame's nonlinearity until the signal
        # crosses zero relative to it.
        for i in range(frame_size):
            x = pcm[c + i * channels]
            if x * a >= 0.0:
                break
            pcm[c + i * channels] = np.float32(x + a * x * x)

        curr = 0
        x0 = pcm[c]
        while True:
            # Find the next sample outside [-1, 1].
            pos = curr
            while pos < frame_size and -1.0 <= pcm[c + pos * channels] <= 1.0:
                pos += 1
            if pos == frame_size:
                a = np.float32(0.0)
                break

            # Expand to the surrounding zero crossings, tracking the peak.
            peak_pos = pos
            start = pos
            end = pos
            maxval = abs(pcm[c + pos * channels])
            while start > 0 and pcm[c + pos * channels] * pcm[c + (start - 1) * channels] >= 0.0:
                start -= 1
            while end < frame_size and pcm[c + pos * channels] * pcm[c + end * channels] >= 0.0:
                if abs(pcm[c + end * channels]) > maxval:
                    maxval = abs(pcm[c + end * channels])
                    peak_pos = end
                end += 1

            special = start == 0 and pcm[c + pos * channels] * pcm[c] >= 0.0

            # Choose a so that maxval + a*maxval^2 == 1, nudged up by 2^-22
            # to guard against fast-math overshoot (reference: lib.rs:593-599).
            a = np.float32((maxval - 1.0) / (maxval * maxval))
            a = np.float32(a + a * np.float32(2.4e-7))
            if pcm[c + pos * channels] > 0.0:
                a = -a

            idx = c + np.arange(start, end) * channels
            seg = pcm[idx]
            pcm[idx] = seg + a * seg * seg

            if special and peak_pos >= 2:
                # Linear ramp from the frame start to the peak to avoid a
                # discontinuity at the frame boundary.
                offset = np.float32(x0 - pcm[c])
                delta = np.float32(offset / peak_pos)
                for i in range(curr, peak_pos):
                    off = c + i * channels
                    offset = np.float32(offset - delta)
                    pcm[off] = np.float32(
                        np.clip(np.float32(pcm[off] + offset), -1.0, 1.0)
                    )

            curr = end
            if curr == frame_size:
                break

        softclip_mem[c] = a
