"""The benchmark of the PyTorch/CUDA port (``d3human_tpu_torch``).

``python -m d3h_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` builds one cell's training step (or, in a fit cell, the
SDF pretraining) on one card, measures it
for a window of ``--seconds`` and prints one JSON line. Everything a cell
is made of is a file found by name: ``configs/<config>.json`` (the
configuration as the port runs it), ``traffic/<traffic>.json`` (the
stage and its feed), ``workloads/<cell>.json`` (config, traffic, chips,
why and the limits of ``correct``) and ``metrics/<metric>.py`` (a reader
of the traced run's record). ``reference/`` is a plain PyTorch copy of
the step path and the fit that decides ``correct``; it imports nothing
of the port.
"""
