"""Batched CELT music encoder (20 ms, CBR) on a torch device: the port of
opus_tpu.batch.encode_pipeline.

The device plane (dsp/encode_exec.py) runs the dense analysis and the PVQ
search for the whole batch: pre-emphasis, the forward MDCT as one matmul,
band energies, dyadic cell stats, and the greedy pulse search (one CUDA
kernel launch on the card).  The host plane (celt/plan_encoder.py, the
reference's per-stream Python) walks each stream's decisions and
range-codes its packet from 21 energies, the cell stats and the searched
pulse vectors; no spectrum reaches the host.

A step: one analyze, one download of band_e / cells / dots, the plan
pass, one upload of the leaf table, the band ops and the table's packed
layout (`leaf_order`: the used rows by width class, each with its start),
one search launch, one download of the packed int16 pulses (only the
used leaves' positions, about 2.4 MB at B = 1,024 against 115 MB padded),
the emit pass, which reads each stream's pulses through `PackedRows`.
On a CUDA device the transfers go through pinned buffers, one copy each.
`step_ms` keeps the last step's host-clock times by phase.

v1 scope, as the reference's: music/CELT 20 ms stereo and mono, long
blocks, tf off, spread SPREAD_NONE, prefilter off.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..celt import modes
from ..celt.plan_encoder import PlanCeltEncoder
from ..dsp.encode_exec import cell_table, make_encode_analyze, make_encode_search
from ..dsp.pvq_search import PackedRows, leaf_order

NB = modes.NB_E_BANDS


class BatchedPlanEncoder:
    """Encode a fixed batch of independent music streams, one 20 ms frame
    per step, on `device`."""

    #: leaf-table capacity: ~70-100 leaves/stream at 96 kbps; streams
    #: that overflow fall back to the host CeltEncoder for that frame.
    P_MAX = 160
    N_MAX = 176
    T_MAX = 128

    def __init__(self, batch: int, channels: int = 2, bitrate: int = 96000, *, device):
        self.batch = batch
        self.channels = channels
        self.bitrate = bitrate
        self.device = torch.device(device)
        self.lm = 3
        self.frame = 960
        self.hosts = [PlanCeltEncoder(channels) for _ in range(batch)]
        self._ana = make_encode_analyze(self.lm, batch, channels, device=self.device)
        self._srch = make_encode_search(self.lm, batch, channels, p_max=self.P_MAX,
                                        n_max=self.N_MAX, t_max=self.T_MAX, device=self.device)
        self._in_mem = torch.zeros((batch, channels, modes.OVERLAP), dtype=torch.float32,
                                   device=self.device)
        self._pm = torch.zeros((batch, channels), dtype=torch.float32, device=self.device)
        #: ToC: CELT fullband 20 ms (config 31), stereo bit from channels
        self.toc = (31 << 3) | (0x4 if channels == 2 else 0)
        n_cells = len(cell_table(self.lm)[0])
        self._stats_cols = (channels * NB, n_cells * 3, 3)  # band_e, cells, dots
        pin = self.device.type == "cuda"

        def host(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=pin)

        self._pcm_h = host((batch, self.frame, channels), torch.float32)
        self._stats_h = host((batch, sum(self._stats_cols)), torch.float32)
        # The leaf table [B, P_MAX, 4], the band ops' float32 bits
        # [B, NB, 4], then the used rows' (row, start) [R, 2]: one upload
        # of the used prefix.
        self._n_leaf_words = batch * self.P_MAX * 4
        self._n_head_words = self._n_leaf_words + batch * NB * 4
        self._up_h = host((self._n_head_words + batch * self.P_MAX * 2,), torch.int32)
        self._up_d = torch.empty_like(self._up_h, device=self.device)
        self._iy_h = host((batch * self.P_MAX * self.N_MAX,), torch.int16)
        #: the last step's host-clock ms by phase
        self.step_ms: dict = {}

    def frame_bytes(self) -> int:
        return max(10, self.bitrate * self.frame // 48000 // 8 - 1)

    def encode_step(self, pcm: np.ndarray) -> list[bytes]:
        """pcm [B, 960, C] f32 +-1 -> one packet per stream."""
        B = self.batch
        nb = self.frame_bytes()
        t0 = time.perf_counter()
        self._pcm_h.numpy()[:] = pcm
        pcm_d = self._pcm_h.to(self.device, non_blocking=True)
        x, band_e, cells, dots, self._in_mem, self._pm = self._ana(pcm_d, self._in_mem,
                                                                     self._pm)
        self._stats_h.copy_(torch.cat([band_e.reshape(B, -1), cells.reshape(B, -1), dots], 1))
        stats = self._stats_h.numpy()
        c1, c2, _ = np.cumsum(self._stats_cols)
        band_e_h = stats[:, :c1].reshape(B, self.channels, NB)
        cells_h = stats[:, c1:c2].reshape(B, -1, 3)
        dots_h = stats[:, c2:]
        t1 = time.perf_counter()

        up = self._up_h.numpy()
        up[: self._n_head_words] = 0
        lv = up[: self._n_leaf_words].reshape(B, self.P_MAX, 4)
        bo = up[self._n_leaf_words : self._n_head_words].view(np.float32).reshape(B, NB, 4)
        plans: list = [None] * B
        for b in range(B):
            leaves, bops = self.hosts[b].plan_frame(
                band_e_h[b], cells_h[b], dots_h[b], nb, self.lm)
            if leaves is None:
                plans[b] = "silence"
                continue
            if len(leaves) > self.P_MAX:
                plans[b] = "overflow"  # host fallback below
                continue
            plans[b] = leaves
            lv[b, : len(leaves)] = leaves
            bo[b] = bops
        t2 = time.perf_counter()

        order = leaf_order(lv, self.N_MAX)
        head, used = self._n_head_words, self._n_head_words + order.rows.size
        up[head:used] = order.rows.reshape(-1)
        self._up_d[:used].copy_(self._up_h[:used], non_blocking=True)
        leaves_d = self._up_d[: self._n_leaf_words].view(B, self.P_MAX, 4)
        bops_d = self._up_d[self._n_leaf_words : head].view(torch.float32).view(B, NB, 4)
        rows_d = self._up_d[head:used].view(-1, 2)
        iy_d, _left = self._srch(x, bops_d, leaves_d, order.on(rows_d))
        iy_h = self._iy_h[: order.total]
        iy_h.copy_(iy_d)
        iy = [PackedRows(iy_h.numpy(), order, b, self.N_MAX) for b in range(B)]
        t3 = time.perf_counter()

        out: list[bytes] = []
        fallback_s = 0.0
        for b in range(B):
            if isinstance(plans[b], str) and plans[b] == "overflow":
                tf = time.perf_counter()
                out.append(self._host_fallback(b, pcm[b], nb))
                fallback_s += time.perf_counter() - tf
                continue
            payload = self.hosts[b].emit_frame(
                band_e_h[b], cells_h[b], dots_h[b], nb, self.lm, iy[b])
            out.append(bytes([self.toc]) + payload)
        t4 = time.perf_counter()
        self.step_ms = {"analyze_and_download": (t1 - t0) * 1e3, "plan": (t2 - t1) * 1e3,
                        "search_and_iy_download": (t3 - t2) * 1e3,
                        "emit": (t4 - t3 - fallback_s) * 1e3, "fallback": fallback_s * 1e3,
                        "fallback_streams": sum(p == "overflow" for p in plans
                                                if isinstance(p, str))}
        return out

    def _host_fallback(self, b: int, pcm1: np.ndarray, nb: int) -> bytes:
        """Pathological leaf counts: encode this stream's frame on the
        host CeltEncoder (state continuity kept via its own carried
        state is NOT maintained across the two engines — v1 restriction;
        overflow needs > P_MAX leaves, unseen below 192 kbps)."""
        host = self.hosts[b].host
        payload = host.encode(np.asarray(pcm1, np.float32), nb)
        self.hosts[b].rng = host.rng
        return bytes([self.toc]) + payload

    def final_ranges(self) -> list[int]:
        return [h.rng for h in self.hosts]
