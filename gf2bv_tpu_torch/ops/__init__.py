"""Solver layer of the port: blocked elimination, its kernels and dispatch."""
