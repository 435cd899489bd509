"""The benchmark of ``xai_tpu_torch``, the PyTorch and CUDA port, on
NVIDIA H100 cards: ``python3 portbench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` from the root of a checkout.  It never
imports JAX or the JAX package ``xai_tpu``."""
