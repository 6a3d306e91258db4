"""The benchmark of the PyTorch and CUDA parameter server.

It measures ``parameter_server_tpu_torch`` alone. One command runs one cell
once (``python psbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``). Every piece is found by name: cells in ``BENCHMARK.json``,
configurations in ``configs/<config>.json``, traffic mixes in
``traffic/<mix>.json``, per-layer metric readers in ``metrics/<metric>.py``,
and the code that drives a configuration's kind of system in
``apps/<app>.py`` (its ``run``, its ``control``, its CPU size ``TINY`` and
its ``FAULTS``), with its plain reference in ``reference/``.
"""
