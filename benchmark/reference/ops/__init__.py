"""Part of the benchmark's plain reference (see ``benchmark.reference``)."""
