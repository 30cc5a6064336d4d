"""The benchmark of the PyTorch and CUDA port, ``cask_tpu_torch``, on one
NVIDIA H100: ``python -m portbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.  Nothing here
imports JAX or the JAX package; the port is reached through its public
entries only."""
