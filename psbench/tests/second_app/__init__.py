"""A cell of a second model, laid out as its files would lie under
``psbench/``, for the benchmark's own tests: ``apps/``, ``reference/``,
``configs/``, ``traffic/`` and ``metrics/`` are copied into a copy of the
benchmark, and ``entries.json`` is merged into its ``BENCHMARK.json``.

``program.py`` stands in for the port's model: the system under test,
outside the benchmark, which the app drives and its fault breaks."""
