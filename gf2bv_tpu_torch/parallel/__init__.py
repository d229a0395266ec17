"""Multi-instance layer of the port: batched solving (parallel/batch.py).
The mesh-sharded solvers of the JAX package are ROADMAP queue 1 item 11."""
