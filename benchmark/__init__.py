"""The benchmark of piecewise_icp_torch (see BENCHMARK.json at the root)."""
