"""opusbench: the benchmark of the PyTorch and CUDA Opus decoder
(`opus_tpu_torch`).

    python3 -m opusbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its file under `workloads/`,
the configuration it names under `configs/`, the packet pools that
configuration names under `traffic/`, the regime that drives it under
`regimes/`, and one reader a metric under `metrics/`.  `reference/` is
the plain scalar decoder that decides whether a run is correct.
"""
