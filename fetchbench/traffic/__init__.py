"""Traffic generators: what the benchmark feeds the program, from data."""
