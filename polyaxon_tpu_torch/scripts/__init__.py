"""The port's measurement tools beside ``polyaxon_tpu_torch.bench``:
``perf_exp`` (a training config sweep, with a profile), ``serve_bench``
(the serving engine's concurrency sweep, prefix sharing and speculation),
``ring_bench`` (ring attention against the all-gather it replaces) and
``pp_bench`` (the pipeline's bubble gate against the ungated schedule).
Each runs on CUDA unless ``--platform cpu`` is given:

    python -m polyaxon_tpu_torch.scripts.perf_exp MODEL BATCH SEQ REMAT [STEPS]
    python -m polyaxon_tpu_torch.scripts.serve_bench [--prefix-share] [--speculative]
    python -m polyaxon_tpu_torch.scripts.ring_bench [--seq 8192,16384] [--cp 8]
    torchrun --nproc-per-node N -m polyaxon_tpu_torch.scripts.pp_bench [--steps 6]
"""
