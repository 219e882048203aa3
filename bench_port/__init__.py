"""The port's benchmark: one command runs one cell (``python3 -m bench_port.run``)."""
