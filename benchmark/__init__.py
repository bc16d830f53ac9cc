"""The benchmark of raytrace_tpu_torch (see BENCHMARK.json at the root of
the repository, and `python3 -m benchmark.run --help`)."""
