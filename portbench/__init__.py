"""The benchmark of ``mies_tpu_torch`` on one NVIDIA H100.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) and prints one JSON line:

    python3 -m portbench.run --workload xray_clahe.archive --seed 7 \
        --seconds 10 --trace 0

Everything that belongs to one configuration, traffic mix, metric, hand
kernel, phantom or reference stage is a file of its own, found by name:

    configs/<config>.json      the chain, its io dtype, slice, batch, limits
    traffic/<traffic>.json     the parameters the one generator reads
    metrics/<metric>.py        read(run) -> number or None
    kernels/<kernel>.py        trace-name pattern, launch counter, work
    phantoms/<phantom>.py      seeded inputs made on the device
    reference/ops/<op>.py      the plain float32 form of one stage

This package imports nothing at import time: ``run.py`` reads the clock
before torch is imported, so set-up counts the import.
"""
