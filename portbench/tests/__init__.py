"""CPU tests of the benchmark (its reference against the port at a small
size, its counts, files and checks)."""
