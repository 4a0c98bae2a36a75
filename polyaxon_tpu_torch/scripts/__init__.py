"""The port's measurement tools beside ``polyaxon_tpu_torch.bench``:
``perf_exp`` (a training config sweep, with a profile) and
``serve_bench`` (the serving engine's concurrency sweep, prefix sharing
and speculation). Each runs on CUDA unless ``--platform cpu`` is given:

    python -m polyaxon_tpu_torch.scripts.perf_exp MODEL BATCH SEQ REMAT [STEPS]
    python -m polyaxon_tpu_torch.scripts.serve_bench [--prefix-share] [--speculative]
"""
