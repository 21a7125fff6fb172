"""The benchmark of `cbtr_tpu_torch`, the PyTorch and CUDA port.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout that holds `BENCHMARK.json`.  Everything a
cell needs is found by name from that file: the configuration's file under
`configs/`, the traffic mix's under `traffic/`, the driver kind it names
under `drivers/`, each per-layer metric's reader under `metrics/` and the
cell's limits under `limits/`.  `reference/` is the plain reference that
decides `correct`; `work/` counts the work the roofline shares are read
against.  Neither imports the port.
"""
