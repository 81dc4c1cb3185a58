"""The end-to-end harness over the port's CLIs, the counterpart of the
repository's `scripts/`: `e2e_hard` (the Table-5 progression), `e2e_seed_variance`,
`e2e_quality`, `bench_render_fps`, `roofline`, and the per-scene `run_*.sh`.

Each module is a library with `main(argv=None)`, run as
`python -m lightgaussian_tpu_torch.scripts.<name>`; importing one parses no
arguments and touches no device.
"""
