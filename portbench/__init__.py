"""The benchmark of `warp_rnnt_tpu_torch` on one NVIDIA card.

`run.py` runs one cell of `BENCHMARK.json` once and prints the result
line; `README.md` says how cells, configurations, traffic mixes and
per-layer metrics are added.  Nothing here imports JAX or the JAX package
`warp_rnnt_tpu`; the program under test is `warp_rnnt_tpu_torch` alone.
"""
