"""Measurement tools of the port, each run on one CUDA device as
``python -m oscar_mpc_planner_mr_modification_tpu_torch.tools.<name>``:
``bench_roofline`` (the FP32 roof, kernel B3, and the achieved FLOP/s of the
fleet paths) and ``bench_warm`` (dual warm starts on the per-iteration
path). Each prints one JSON line and exits with code 2 without a card."""
