"""Where the PVQ search kernel spends its time, on one NVIDIA GPU.

    python3 tools/pvq_phases.py [--against OTHER/pvq.cu ...]

Builds opus_tpu_torch/csrc/pvq.cu as it is (nvcc, sm_90a, into the
gitignored opus_tpu_torch/_build/pvq_phases/) and, with --against, other
pvq.cu files with the same C entry (an earlier commit's, unpacked with `git
archive`), timed in turns with the source (others, source, source, others
in reverse).
The inputs are the search inputs of the first step of chip_smoke.py's
encode path, recorded: BatchedPlanEncoder(chip_smoke.B, 2, 96000) on
`music_pcm`.  Prints, beside the card's name, power limit and top SM clock:

* each copy's device time per launch (a CUDA graph of 10 launches, two
  output copies in turn) and whether its iy and left equal the plain
  version's;
* the source's time with the row list cut to each width class alone, with
  t_max = 0 (the prologue and the writes, no trip), with no leaf (the
  memset of `left` and the launch) and with one;
* two probes, copies of the source timed in turns with it whose pulses are
  wrong (timing only): "fast division" (the trips' correctly rounded
  quotient replaced by __fdividef) and "no stereo op" (every position
  read from its plane as it is: no band table, no band ops);
* the cycles between clock64() marks in the first warp of the widest
  class's first block and of the 8-lane class's: the start of the block,
  the leaf row read, the stereo op, the prefill, the trips and the writes
  (a marked copy of the source).  A mark whose anchor no longer matches
  the source fails the run.

Needs a CUDA device and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


#: (anchor in pvq.cu, the mark goes before it); mark k is the k-th.
MARKS = [
    "  int cls = 0;\n",
    "  const int ln = leaf.z, kk = leaf.w;\n",
    "  // Projection prefill (K > n / 2).\n",
    "  // Greedy trips: one pulse a trip",
    "  short* out = a.iy + start;\n",
    "}\n\n// The leaves of class `cls` that this warp searches",
]
PHASES = ["to the first leaf", "loads and stereo op", "prefill", "trips", "writes"]
#: probe name -> (anchor in pvq.cu, its replacement)
PROBES = {
    "fast division": ("        const float sc = __fdiv_rn(__fmul_rn(s, s), fmaxf(den, eps));\n",
                      "        const float sc = __fdividef(__fmul_rn(s, s), fmaxf(den, eps));\n"),
    "no stereo op": ("      if (side_plane)\n        src = op.x == 2.f ? __fmul_rn(__fsub_rn(v1, v0), "
                     "rt2) : v1;\n      else if (op.x == 2.f)\n        src = __fmul_rn(__fadd_rn("
                     "v0, v1), rt2);\n      else if (op.x == 3.f)\n        src = __fadd_rn("
                     "__fmul_rn(op.y, v0), __fmul_rn(op.z, v1));\n      else\n        src = v0;\n",
                     "      src = side_plane ? v1 : v0;\n"),
}


def marked(src: str) -> str:
    """The source with a clock64() mark before each anchor of MARKS, kept by
    thread 0 of block 0 (the widest class) and of the 8-lane class's first
    block (marks 8 on), the first time it passes each after a reset: its
    first leaf."""
    for k, anchor in enumerate(MARKS):
        if src.count(anchor) != 1:
            raise RuntimeError(f"mark {k}: its anchor is not in pvq.cu once: {anchor!r}")
        src = src.replace(anchor, f"  PHASE({k})\n" + anchor)
    src = src.replace(
        "#include <cuda_runtime.h>\n",
        "#include <cuda_runtime.h>\n__device__ long long g_phase[16];\n"
        "#define PHASE(k) if (threadIdx.x == 0 && (blockIdx.x == 0 || blockIdx.x == "
        "a.first_block[3]) && !g_phase[(blockIdx.x != 0) * 8 + (k)]) "
        "g_phase[(blockIdx.x != 0) * 8 + (k)] = clock64();\n", 1)
    return src + ('\nextern "C" int read_phases(long long* out) {\n'
                  "  return cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));\n}\n"
                  'extern "C" int reset_phases() {\n  const long long zero[16] = {};\n'
                  "  return cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));\n}\n")


def probed(src: str, name: str) -> str:
    anchor, text = PROBES[name]
    if src.count(anchor) != 1:
        raise RuntimeError(f"probe {name}: its anchor is not in pvq.cu once: {anchor!r}")
    return src.replace(anchor, text)


def build(srcs: dict) -> dict:
    """name -> the loaded library of each copy, built by parallel nvccs."""
    from opus_tpu_torch import _build

    out = ROOT / "opus_tpu_torch" / "_build" / "pvq_phases"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        stem = out / name
        stem.with_suffix(".cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-shared", "-o", str(stem.with_suffix(".so")),
             str(stem.with_suffix(".cu"))], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{log}")
        libs[name] = _build.bind(ctypes.CDLL(str((out / name).with_suffix(".so"))),
                                 ["opus_pvq_search"])
    return libs


def recorded_step(dev) -> tuple:
    """(x, band_ops, leaves) the encode path's first step searches."""
    import chip_smoke as cs
    from opus_tpu_torch.batch.encode_pipeline import BatchedPlanEncoder

    enc = BatchedPlanEncoder(cs.B, cs.C, 96000, device=dev)
    rec, search = {}, enc._srch

    def record(x, ops, leaves, order):
        rec.update(x=x.clone(), ops=ops.clone(), leaves=leaves.clone())
        return search(x, ops, leaves, order)

    enc._srch = record
    enc.encode_step(cs.music_pcm(cs.B, 1)[0])
    return rec["x"], rec["ops"], rec["leaves"]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--against", type=pathlib.Path, nargs="+", default=[],
                        help="other pvq.cu files to time in turns with the source")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("pvq_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from opus_tpu_torch.dsp import pvq_search as pq

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    src = (ROOT / "opus_tpu_torch" / "csrc" / "pvq.cu").read_text()
    srcs = {"source": src, "marked": marked(src)}
    probes = [f"probe_{k}" for k in range(len(PROBES))]
    for name, probe in zip(probes, PROBES):
        srcs[name] = probed(src, probe)
    others = [f"against_{k}_{path.stem}" for k, path in enumerate(opts.against)]
    for name, path in zip(others, opts.against):
        srcs[name] = path.read_text()
    libs = build(srcs)
    dev = torch.device("cuda")
    x, ops, leaves = recorded_step(dev)
    order = pq.leaf_order(leaves.cpu().numpy(), cs.ENC_N_MAX)
    rows = torch.from_numpy(order.rows).to(dev)
    want_iy, want_left = pq._pvq_search_ref(x, ops, leaves)
    want_iy = pq.pack(want_iy, leaves)
    outs = [(torch.empty(order.total, dtype=torch.int16, device=dev),
             torch.empty(leaves.shape[:2], dtype=torch.int32, device=dev)) for _ in range(2)]

    def prepared(rows_, counts, t_max=cs.ENC_T_MAX):
        return [pq._kernel_args(x, ops, leaves, rows_, order._replace(counts=counts), iy, left,
                                3, t_max) for iy, left in outs]

    full = prepared(rows, order.counts)
    times, equal = {}, {}
    for name in [*others, "source", "source", *others[::-1]]:
        times.setdefault(name, []).append(cs.graph_ms(libs[name].opus_pvq_search, full, 10))
        torch.cuda.synchronize()
        equal[name] = bool(torch.equal(outs[0][0], want_iy) and torch.equal(outs[0][1], want_left))
    print(f"pvq_search encode step 0 B={cs.B}: {int((leaves[..., 2] > 0).sum())} leaves, by "
          f"width class {pq.class_ranges(cs.ENC_N_MAX)} {order.counts}; device ms/launch (CUDA "
          f"graph) {times}; iy and left equal to the plain version {equal} ({card})")
    lib, base = libs["source"].opus_pvq_search, np.cumsum((0, *order.counts))
    alone = {}
    for c, tiles in enumerate(pq.CLASS_TILES):
        counts = tuple(n if k == c else 0 for k, n in enumerate(order.counts))
        alone[f"class {c} ({tiles} lanes)"] = cs.graph_ms(
            lib, prepared(rows[base[c] : base[c + 1]], counts), 10)
    alone["t_max 0 (no trip)"] = cs.graph_ms(lib, prepared(rows, order.counts, 0), 10)
    alone["no leaf"] = cs.graph_ms(lib, prepared(rows[:0], (0, 0, 0, 0)), 10)
    alone["one leaf"] = cs.graph_ms(lib, prepared(rows[:1], (1, 0, 0, 0)), 10)
    for name, probe in zip(probes, PROBES):
        alone[f"probe {probe}"] = cs.graph_ms(libs[name].opus_pvq_search, full, 10)
    alone["source again"] = cs.graph_ms(lib, full, 10)
    print(f"pvq_search source, device ms/launch (CUDA graph) by part: {alone} ({card})")
    marked_lib = libs["marked"]
    stream = torch.cuda.current_stream().cuda_stream
    for k in range(3):  # the marks of the third launch
        torch.cuda.synchronize()
        if k == 2 and marked_lib.reset_phases() != 0:
            raise RuntimeError("resetting the marks failed")
        if marked_lib.opus_pvq_search(*full[0], stream) != 0:
            raise RuntimeError("the marked copy failed to launch")
    torch.cuda.synchronize()
    marks = (ctypes.c_longlong * 16)()
    if marked_lib.read_phases(marks) != 0:
        raise RuntimeError("reading the marks failed")
    for name, at in (("widest class, block 0", 0), ("8-lane class, its first block", 8)):
        cycles = {p: marks[at + k + 1] - marks[at + k] for k, p in enumerate(PHASES)}
        print(f"pvq_search first warp of the {name}: cycles by phase {cycles}, total "
              f"{marks[at + len(PHASES)] - marks[at]} ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
